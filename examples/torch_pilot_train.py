"""End-to-end driver of the PyTorch port: train an LM THROUGH the Pilot-Data
abstractions, as ``examples/pilot_train.py`` does with the JAX package.

The run is ONE declaratively-submitted CU/DU DAG on the port's Session API
(``repro_torch.core``): chunked shard DUs (data), a checkpoint-DU chain
(model state, written by ``repro_torch``'s ``Checkpointer``) wired
future-to-future, ``train_chunk`` CUs late-bound to pilots co-located with
their inputs.  Every checkpoint DU carries ``replication_factor=2``, so the
runtime's ReplicaManager disperses it across pods as it seals.  Each chunk
restores its checkpoint onto ``--device`` and runs the port's train step
there: on CUDA every attention, norm and (for other families) scan goes
through the port's kernels; ``--device cpu`` runs their plain versions.

Run (demo, 30 steps, on the GPU):
  PYTHONPATH=src python examples/torch_pilot_train.py
Run (the same on the CPU, with the kernels' plain versions):
  PYTHONPATH=src python examples/torch_pilot_train.py --device cpu
Run (full, ~100M params, 300 steps):
  PYTHONPATH=src python examples/torch_pilot_train.py --preset full
"""

import argparse
import dataclasses
import time

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import Session, make_tpu_fleet_topology
from repro_torch.training.trainer import PilotTrainer

PRESETS = {
    # a few M params — quick demo (head_dim 64: an instance of the kernels;
    # examples/pilot_train.py's demo has 32)
    "demo": dict(
        model=dict(
            n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
            vocab_size=2048, head_dim=64,
        ),
        total_steps=30, chunk_steps=10, batch=8, seq=128,
        tokens_per_shard=200_000,
    ),
    # ~100M params — the end-to-end driver scale
    "full": dict(
        model=dict(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
            vocab_size=32000, head_dim=64,
        ),
        total_steps=300, chunk_steps=25, batch=8, seq=256,
        tokens_per_shard=2_000_000,
    ),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="demo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = ap.parse_args()
    preset = PRESETS[args.preset]

    cfg = reduced(get_config("h2o-danube-1.8b"), **preset["model"])
    cfg = dataclasses.replace(cfg, name=f"torch-pilot-train-{args.preset}")
    print(f"model: {cfg.name} — {cfg.param_count()/1e6:.1f}M params on {args.device}")

    topo, _ = make_tpu_fleet_topology(pods=2, hosts_per_pod=1)
    with Session(
        topology=topo, enable_fault_manager=True, heartbeat_timeout_s=2.0
    ) as s:
        # data lives on each pod's shared FS; pilots on both pods
        s.start_pilot_data(
            service_url="sharedfs://cluster:pod0/scratch", affinity="cluster:pod0"
        )
        s.start_pilot_data(
            service_url="sharedfs://cluster:pod1/scratch", affinity="cluster:pod1"
        )
        s.start_pilot(resource_url="sim://cluster:pod0:host0", slots=1)
        s.start_pilot(resource_url="sim://cluster:pod1:host0", slots=1)

        tr = PilotTrainer(
            cfg,
            s,
            total_steps=preset["total_steps"],
            chunk_steps=preset["chunk_steps"],
            batch=preset["batch"],
            seq=preset["seq"],
            peak_lr=3e-3,
            n_shards=2,
            tokens_per_shard=preset["tokens_per_shard"],
            run_name=cfg.name,
            ckpt_replication=2,
            device=args.device,
        )
        tr.stage_data(affinities=["cluster:pod0", "cluster:pod1"])
        t0 = time.time()
        summary = tr.run(timeout_per_chunk=3600)
        dt = time.time() - t0
        print(f"\ntrained {summary['steps']} steps in {dt:.0f}s "
              f"({summary['chunks']} chunks on pilots {summary['pilots_used']})")
        print(f"loss: {summary['first_loss']:.3f} → {summary['final_loss']:.3f} "
              f"(improved={summary['improved']})")
        for h in summary["history"]:
            print(f"  chunk {h['chunk']:3d} steps={h['steps']} pilot={h['pilot']} "
                  f"loss_tail={h['losses'][-1]:.3f}")
        last = tr.ckpt_dus[-1]
        params = tr.restore_params()
        print(f"restored params from {last.url} "
              f"(replicas: {last.locations}): {len(params)} top-level entries")


if __name__ == "__main__":
    main()
