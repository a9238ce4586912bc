"""Checkpointing as Data-Units.

A checkpoint is an immutable DU whose files are the serialized leaves of
(params, opt_state, step).  That buys, for free, everything the paper's DU
semantics give data:

  * location transparency — restart anywhere the DU has (or can get) a
    replica;
  * replication — the DU carries a ``replication_factor``; sealing it
    hands dispersal and post-failure healing to the runtime's
    ReplicaManager/FaultManager (failure-domain-aware, chunk-striped),
    so a pod loss does not lose the run and NO checkpoint-layer code is
    involved in recovery;
  * affinity scheduling — the workload manager restarts the training CU
    near a checkpoint replica instead of dragging bytes across the DCN;
  * catalog — the coordination store maps ``ckpt:<run>`` to the DU chain.

Replication-factor enforcement requires the self-healing pipeline
(``enable_fault_manager=True`` on the Session/PilotManager); without it a
checkpoint still seals and restores, but keeps a single replica.

Leaves are stored whole (single-process container); a multi-host deployment
would store per-shard files keyed by shard index — the DU file namespace
already accommodates that (``leaf/<path>/shard<k>.npy``).

Restore is *resharding*: leaves come back as CPU torch tensors and are moved
to whatever device the caller runs on.

The counterpart of ``repro.checkpoint.checkpointer``, written on the port's
array codec (:mod:`.codec`): the same file-set byte for byte (bf16 leaves as
``<V2`` ``.npy`` files), so a checkpoint DU written by either package loads in
the other.
"""

from __future__ import annotations

import json
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, List, Optional, Tuple

from ..core import DataUnit, DataUnitDescription, DUState, RuntimeContext
from .codec import checkpoint_files, decode_array, unflatten_tree


class CheckpointError(RuntimeError):
    """An asynchronous checkpoint commit failed."""


class CheckpointTimeout(CheckpointError, TimeoutError):
    """``wait()`` deadline elapsed with commits still in flight."""


class Checkpointer:
    """Writes/reads checkpoint DUs; replication rides the runtime.

    Attach to a :class:`~repro_torch.core.session.Session` (or a PilotManager —
    anything with ``.ctx``/``.cds``); a bare :class:`RuntimeContext` also
    works but then every ``save`` needs an explicit ``target``.

    Asynchronous commits run on ONE background executor (not a thread per
    save) and their failures are never swallowed: the next ``save()``
    re-raises a completed commit's error, and :meth:`wait` raises — a
    :class:`CheckpointError` for failed commits, :class:`CheckpointTimeout`
    when the deadline elapses with commits still in flight.
    """

    def __init__(
        self,
        runtime: Any,
        run_name: str = "run",
        replication_factor: int = 1,
    ):
        self.ctx: RuntimeContext = getattr(runtime, "ctx", runtime)
        self.cds = getattr(runtime, "cds", None)
        self.run_name = run_name
        self.replication_factor = replication_factor
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    # ----------------------------------------------------------------- save
    def _commit(self, du: DataUnit, step: int, target) -> DataUnit:
        pd = target
        if pd is None and self.cds is not None:
            pd = self.cds.choose_pilot_data(du.description)
        if pd is None:
            raise CheckpointError(
                f"{self.run_name} step {step}: no Pilot-Data target "
                f"(start one, or pass target=)"
            )
        self.ctx.store.hset(f"du:{du.id}", "state", DUState.PENDING)
        self.ctx.transfer_service.ingest(du, pd)
        # Sealing publishes the immutable manifest; with the fault manager
        # enabled the ReplicaManager now disperses the DU to its declared
        # replication_factor across failure domains — off this thread.
        du.seal()
        self.ctx.store.hset(f"ckpt:{self.run_name}", f"{step:08d}", du.id)
        return du

    def save(
        self,
        step: int,
        params: Any,
        opt_state: Optional[Any] = None,
        target=None,
        asynchronous: bool = False,
    ) -> DataUnit:
        self.check()  # surface any completed async commit's failure NOW
        desc = DataUnitDescription(
            name=f"{self.run_name}.ckpt{step:08d}",
            files=checkpoint_files(step, self.run_name, params, opt_state),
            replication_factor=self.replication_factor,
        )
        du = DataUnit(desc, self.ctx.store)
        self.ctx.register(du)
        if asynchronous:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-commit"
                )
            self._pending.append(self._pool.submit(self._commit, du, step, target))
        else:
            self._commit(du, step, target)
        return du

    def check(self) -> None:
        """Re-raise the first failure among *completed* async commits
        (commits still running are left pending)."""
        still, failed = [], []
        for fut in self._pending:
            if not fut.done():
                still.append(fut)
            elif fut.exception() is not None:
                failed.append(fut.exception())
        self._pending = still
        if failed:
            raise CheckpointError(
                f"{self.run_name}: async checkpoint commit failed: "
                f"{failed[0]}"
            ) from failed[0]

    def wait(self, timeout: float = 30.0) -> None:
        """Block until every pending async commit settles.

        Raises :class:`CheckpointError` if any commit failed and
        :class:`CheckpointTimeout` if the deadline elapses first (the
        unfinished commits stay pending for a later ``wait``)."""
        pending, self._pending = self._pending, []
        done, not_done = futures_wait(pending, timeout=timeout)
        failed = [f.exception() for f in done if f.exception() is not None]
        self._pending = list(not_done)
        if failed:
            raise CheckpointError(
                f"{self.run_name}: async checkpoint commit failed: "
                f"{failed[0]}"
            ) from failed[0]
        if not_done:
            raise CheckpointTimeout(
                f"{self.run_name}: {len(not_done)} checkpoint commit(s) "
                f"still in flight after {timeout}s"
            )

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        index = self.ctx.store.hgetall(f"ckpt:{self.run_name}")
        return max((int(k) for k in index), default=None)

    def du_for_step(self, step: int) -> DataUnit:
        du_id = self.ctx.store.hget(f"ckpt:{self.run_name}", f"{step:08d}")
        if du_id is None:
            raise KeyError(f"no checkpoint for step {step}")
        return self.ctx.lookup(du_id)

    def restore(
        self, step: Optional[int] = None, location: Optional[str] = None
    ) -> Tuple[int, Any, Optional[Any]]:
        """Returns (step, params, opt_state) read from the nearest replica."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise KeyError(f"run {self.run_name!r} has no checkpoints")
        du = self.du_for_step(step)
        return load_checkpoint_du(self.ctx, du, location=location)


def load_checkpoint_du(
    ctx: RuntimeContext, du: DataUnit, location: Optional[str] = None
) -> Tuple[int, Any, Optional[Any]]:
    """Read a checkpoint DU (via the cheapest replica when location given)."""
    pd = None
    if du.locations:
        if location is not None and ctx.transfer_service is not None:
            pd, _ = ctx.transfer_service.resolve_access(du, location)
        if pd is None:
            pd = ctx.lookup(du.locations[0])

    def read(rel: str) -> bytes:
        return pd.fetch_du_file(du.id, rel) if pd is not None else du.read(rel)

    meta = json.loads(read("meta.json"))
    params_items, opt_items = {}, {}
    for rel in du.manifest:
        if not rel.endswith(".npy"):
            continue
        key = rel[: -len(".npy")]
        if key.startswith("params/"):
            params_items[key[len("params/") :]] = decode_array(read(rel))
        elif key.startswith("opt/"):
            opt_items[key[len("opt/") :]] = decode_array(read(rel))
    params = unflatten_tree(params_items)
    opt = unflatten_tree(opt_items) if opt_items else None
    return meta["step"], params, opt
