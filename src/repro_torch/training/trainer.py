"""PilotTrainer: training as a Pilot-Data dataflow; the counterpart of
``repro.training.trainer``.

The run is expressed in the paper's nouns (§4.3.2, Fig. 5), as the JAX
trainer's is:

  * the corpus is partitioned into *chunked* shard DUs (partitioned data)
    placed by affinity across Pilot-Data;
  * model state moves through the run as a chain of immutable checkpoint
    DUs carrying a ``replication_factor`` — healing after a pilot loss is
    the runtime's ReplicaManager, not trainer code;
  * each training chunk (N optimizer steps) is a Compute-Unit with
    ``input_data = [shard_du, ckpt_{i-1}]`` and ``output_data = [ckpt_i]``;
  * the Compute-Data Service late-binds each chunk to a pilot co-located
    with its inputs, re-queues it if a pilot dies (restart from
    ckpt_{i-1}), and new pilots added mid-run start pulling chunks.

The whole chunk DAG is submitted in one shot through the port's Session
API (:mod:`repro_torch.core`).  Inside a chunk CU the checkpoint is decoded
leaf by leaf onto the trainer's device, the shard's numpy batches move to
that device one step at a time, and the port's train step runs there (on
the card: flash attention and RMSNorm, forward and backward, through their
kernels).  The checkpoint files are the JAX package's, byte for byte, so a
chain may start from a ``ckpt_0`` written by either package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..checkpoint import checkpoint_files, decode_array, unflatten_tree
from ..configs.base import ModelConfig
from ..core import FUNCTIONS, DataUnitDescription
from ..core.futures import CUFuture, DUFuture
from ..data import (
    SHARD_CHUNK_BYTES,
    Prefetcher,
    ShardReader,
    StreamingShardReader,
    make_token_shards,
    stage_shard_dus,
)
from ..models import build_model
from ..optim import init_adamw
from .train_step import make_train_step


def _restore_from_input(cu_ctx, ckpt_du: str, device: torch.device) -> Tuple[Any, Any]:
    """(params, opt_state) on ``device`` from a checkpoint DU staged as a CU
    input, decoded one leaf at a time as ``bridge.train_state_from_files``
    decodes a file-set."""
    items_p, items_o = {}, {}
    for rel in cu_ctx.input_manifest(ckpt_du):
        if rel.startswith("params/") and rel.endswith(".npy"):
            items_p[rel[7:-4]] = decode_array(cu_ctx.read_input(ckpt_du, rel)).to(device)
        elif rel.startswith("opt/") and rel.endswith(".npy"):
            items_o[rel[4:-4]] = decode_array(cu_ctx.read_input(ckpt_du, rel)).to(device)
    return unflatten_tree(items_p), unflatten_tree(items_o)


class PilotTrainer:
    """Drives a training run as one declaratively-submitted CU/DU DAG.

    ``runtime`` is a :class:`~repro_torch.core.session.Session` or anything
    that exposes one (``PilotManager.session``).  ``ckpt_replication`` is the
    replication factor stamped on every checkpoint DU.  ``device`` is where
    the chunk CUs train; it is CUDA unless the caller asks for the CPU, and
    the constructor raises if CUDA is asked for and absent.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        runtime: Any,
        total_steps: int = 20,
        chunk_steps: int = 5,
        batch: int = 4,
        seq: int = 64,
        peak_lr: float = 1e-3,
        n_shards: int = 2,
        tokens_per_shard: int = 50_000,
        seed: int = 0,
        run_name: str = "pilot-train",
        ckpt_replication: int = 1,
        shard_chunk_bytes: int = SHARD_CHUNK_BYTES,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = cfg
        # a PilotManager exposes its v2 facade as .session; a Session IS one
        self.session = getattr(runtime, "session", runtime)
        self.total_steps = total_steps
        self.chunk_steps = chunk_steps
        self.batch = batch
        self.seq = seq
        self.peak_lr = peak_lr
        self.n_shards = n_shards
        self.tokens_per_shard = tokens_per_shard
        self.seed = seed
        self.run_name = run_name
        self.ckpt_replication = ckpt_replication
        self.shard_chunk_bytes = shard_chunk_bytes
        self.api = build_model(cfg, device=device)
        # made once per trainer, as the JAX trainer's lru_cache makes its
        # jitted step once
        self.train_step = make_train_step(
            self.api,
            peak_lr=peak_lr,
            warmup_steps=max(2, total_steps // 10),
            total_steps=total_steps,
        )
        self.shard_dus: List[DUFuture] = []
        self.ckpt_dus: List[DUFuture] = []
        self.history: List[Dict] = []
        self._register_executable()

    # ------------------------------------------------------------ plumbing
    def _register_executable(self) -> None:
        me = self
        device = self.api.device

        def train_chunk(cu_ctx, shard_du, ckpt_du, start_step, n_steps, batch, seq):
            params, opt_state = _restore_from_input(cu_ctx, ckpt_du, device)
            # --- data from the co-located shard DU ---
            manifest = cu_ctx.input_manifest(shard_du)
            if any(rel.endswith(".bin") for rel in manifest):
                # chunk-streamable raw shard: consume the canonical byte
                # stream chunk by chunk
                reader = StreamingShardReader(cu_ctx, shard_du)
            else:
                reader = ShardReader.from_cu_context(cu_ctx, shard_du, seed=me.seed)
            batches = Prefetcher(reader.batches(batch, seq, start_step=start_step), depth=2)
            losses = []
            try:
                for _, b in zip(range(n_steps), batches):
                    b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
                    params, opt_state, metrics = me.train_step(params, opt_state, b)
                    losses.append(float(metrics["loss"]))
            finally:
                batches.close()
            if device.type == "cuda":
                # agent threads share the default stream: the state is final
                # before it is encoded (and before the next CU stages in)
                torch.cuda.synchronize(device)
            # --- emit the next checkpoint DU; the device state goes first ---
            files = checkpoint_files(start_step + n_steps, me.run_name, params, opt_state)
            del params, opt_state
            for rel, data in files.items():
                cu_ctx.write_output(rel, data)
            return {"losses": losses, "final_loss": losses[-1] if losses else None}

        FUNCTIONS.register(f"train_chunk:{self.run_name}", train_chunk)

    # ---------------------------------------------------------------- setup
    def stage_data(self, affinities: Optional[List[Optional[str]]] = None) -> None:
        """Create + place the shard DUs (partitioned-data pattern): raw
        chunk-streamable format, chunked manifests, affinity round-robin."""
        shards = make_token_shards(
            self.n_shards,
            self.tokens_per_shard,
            self.cfg.vocab_size,
            seed=self.seed,
            fmt="raw",
        )
        self.shard_dus = stage_shard_dus(
            self.session,
            shards,
            name=self.run_name,
            affinities=affinities,
            chunk_size=self.shard_chunk_bytes,
        )

    def initial_checkpoint(self) -> DUFuture:
        """ckpt_0 from fresh init (also a DU, so chunk 0 is uniform).

        The weights come from the port's ``api.init(seed=...)`` and so differ
        from the JAX trainer's ``init(PRNGKey(seed))``; a run that must start
        from the JAX weights submits the JAX ``ckpt_0`` files as a DU and puts
        it in ``ckpt_dus`` before :meth:`submit_dag`."""
        params = self.api.init(seed=self.seed)
        files = checkpoint_files(0, self.run_name, params, init_adamw(params))
        del params
        fut = self.session.submit_du(
            name=f"{self.run_name}.ckpt{0:08d}",
            files=files,
            replication_factor=self.ckpt_replication,
        )
        self.session.store.hset(f"ckpt:{self.run_name}", f"{0:08d}", fut.id)
        self.ckpt_dus.append(fut)
        return fut

    # ----------------------------------------------------------------- run
    def submit_dag(self) -> List[Tuple[int, int, int, CUFuture]]:
        """Submit the ENTIRE chunk chain upfront — one shot, no user-side
        waits between chunks.  Each chunk's checkpoint input is the
        previous chunk's output DUFuture; the runtime's DU-readiness gate
        sequences the chain.

        Returns ``[(chunk_idx, start_step, n_steps, cu_future), ...]``."""
        if not self.shard_dus:
            self.stage_data()
        ckpt = self.ckpt_dus[-1] if self.ckpt_dus else self.initial_checkpoint()
        chunks = []
        step = 0
        chunk_idx = 0
        while step < self.total_steps:
            n = min(self.chunk_steps, self.total_steps - step)
            shard = self.shard_dus[chunk_idx % len(self.shard_dus)]
            # no hard affinity constraint: data locality is a SOFT preference
            # expressed through the CDS's input-data scoring (§6.1); a hard
            # constraint would pin chunks to a site after its pilots die
            cu = self.session.submit_cu(
                executable=f"train_chunk:{self.run_name}",
                args=(shard.id, ckpt.id, step, n, self.batch, self.seq),
                input_data=[shard, ckpt],
                output_data=[
                    DataUnitDescription(
                        name=f"{self.run_name}.ckpt{step + n:08d}",
                        replication_factor=self.ckpt_replication,
                    )
                ],
                max_retries=4,
            )
            chunks.append((chunk_idx, step, n, cu))
            ckpt = cu.output
            step += n
            chunk_idx += 1
        return chunks

    def run(self, timeout_per_chunk: float = 300.0) -> Dict[str, Any]:
        """Submit the one-shot DAG, then collect; returns the loss summary."""
        chunks = self.submit_dag()
        for chunk_idx, step, n, cu in chunks:
            res = cu.result(timeout=timeout_per_chunk)
            self.history.append(
                {
                    "chunk": chunk_idx,
                    "steps": (step, step + n),
                    "pilot": cu.pilot_id,
                    "losses": res["losses"],
                    "t_s_sim": cu.timings.sim_stage_s,
                }
            )
            self.ckpt_dus.append(cu.output)
            self.session.store.hset(
                f"ckpt:{self.run_name}", f"{step + n:08d}", cu.output.id
            )
        first = self.history[0]["losses"][0]
        last = self.history[-1]["losses"][-1]
        return {
            "steps": self.total_steps,
            "chunks": len(chunks),
            "first_loss": first,
            "final_loss": last,
            "improved": last < first,
            "pilots_used": sorted({h["pilot"] for h in self.history}),
            "history": self.history,
        }

    def restore_params(self) -> Any:
        """Params from the latest checkpoint DU, as CPU tensors."""
        from ..checkpoint import load_checkpoint_du

        ctx = self.session.ctx
        du = ctx.lookup(self.ckpt_dus[-1].id)
        _, params, _ = load_checkpoint_du(ctx, du)
        return params
