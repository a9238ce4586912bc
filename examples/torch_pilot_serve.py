"""Serving driver of the PyTorch port: a pilot fleet cold-starts decode
replicas from ONE model checkpoint DU, as ``examples/pilot_serve.py`` does
with the JAX package.

The checkpoint is written once by ``repro_torch``'s ``Checkpointer`` with
``replication_factor=2`` (the runtime's ReplicaManager disperses it across
pods as it seals), and every serve CU declares it as ``input_data`` — so
each replica's weight load goes through the transfer service, feeds the
TierManager's access stats, and after ``tier_promote_after`` loads at a site
the DU is PROMOTED into the site's mem-tier cache.  Each replica builds its
engine with ``DecodeEngine.from_cu_context``: the weights land on
``--device``, and on CUDA every decode step runs the port's decode-attention
and RMSNorm kernels; ``--device cpu`` runs their plain versions.

Run (demo: two replicas on one pod's two hosts, on the GPU):
  PYTHONPATH=src python examples/torch_pilot_serve.py
Run (the same on the CPU, with the kernels' plain versions):
  PYTHONPATH=src python examples/torch_pilot_serve.py --device cpu
Run (full: two replicas on each of two pods, pilot_serve.py's fleet):
  PYTHONPATH=src python examples/torch_pilot_serve.py --preset full
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core import FUNCTIONS, Session, make_tpu_fleet_topology
from repro_torch.models import build_model
from repro_torch.serving import DecodeEngine

#: the pods whose two hosts each run one decode replica
PRESETS = {"demo": dict(serve_pods=(0,)), "full": dict(serve_pods=(0, 1))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="demo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = ap.parse_args()
    serve_pods = PRESETS[args.preset]["serve_pods"]

    # reduced same-family config; head_dim 64 (the smoke config's is 16) is
    # an instance of the kernels
    cfg = dataclasses.replace(get_config("gemma3-1b-smoke"), head_dim=64)
    api = build_model(cfg, device=args.device)
    topo, _ = make_tpu_fleet_topology(pods=2, hosts_per_pod=2)
    with Session(
        topology=topo,
        enable_fault_manager=True,      # heals the ckpt DU to its factor
        tier_cache_bytes=256 * 1024 * 1024,
        tier_promote_after=2,           # promote on the 2nd load at a site
    ) as s:
        # "trained" params, checkpointed ONCE as a replicated DU
        s.start_pilot_data(
            service_url="sharedfs://cluster:pod0/ckpt", affinity="cluster:pod0"
        )
        s.start_pilot_data(
            service_url="sharedfs://cluster:pod1/ckpt", affinity="cluster:pod1"
        )
        params = api.init(seed=0)
        ck = Checkpointer(s, run_name="torch-serve-model", replication_factor=2)
        du = ck.save(0, params)
        del params
        deadline = time.time() + 10
        while time.time() < deadline and len(du.locations) < 2:
            time.sleep(0.05)
        print(f"model checkpoint {du.url} healed to {du.locations}")

        # serve executable: weights come from the DU declared as CU input —
        # the tier-cache-eligible cold-start path
        @FUNCTIONS.register("torch_serve_batch")
        def serve_batch(cu_ctx, weights_du, prompt_tokens, new_tokens):
            engine = DecodeEngine.from_cu_context(api, cu_ctx, weights_du,
                                                  batch=len(prompt_tokens), max_len=64)
            out = engine.generate(torch.tensor(prompt_tokens, dtype=torch.int32), new_tokens)
            return out.cpu().tolist()

        # the fleet: two pilots per serving pod, one decode replica each
        for pod in serve_pods:
            for host in (0, 1):
                s.start_pilot(
                    resource_url=f"sim://cluster:pod{pod}:host{host}", slots=1
                )
        prompts = [[1, 5, 9, 2], [3, 3, 7, 1]]
        t0 = time.time()
        cus = [
            s.submit_cu(
                executable="torch_serve_batch",
                args=(du.id, prompts, 8),
                input_data=[du],
                affinity=f"cluster:pod{pod}",
            )
            for pod in serve_pods
            for _ in range(2)
        ]
        outs = [cu.result(timeout=300) for cu in cus]
        for cu, out in zip(cus, outs):
            print(f"{cu.url} on {cu.pilot_id}: generated {out}")
        # every replica must decode identically from its local copy
        assert all(o == outs[0] for o in outs), "replica divergence!"
        tm = s.tier_manager
        stats = tm.access_stats(du.id)
        print(
            f"served {len(cus)} replicas on {args.device} in {time.time()-t0:.1f}s — "
            f"consistent ✓  (ckpt DU accesses: {stats}, "
            f"mem-tier promotions: {tm.promotions_total})"
        )


if __name__ == "__main__":
    main()
