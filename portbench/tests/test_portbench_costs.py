"""The frozen cost functions equal the program's on the day they were
frozen, at both cells' shapes and at the kernel table's rows (PERF.md).
Not kept in step with later changes to the program: a failure here says
that the program's own arithmetic has moved, not the yardstick."""

import json
from pathlib import Path

import pytest

from portbench import costs
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"

# (b, sq, sk, hq, hkv, d, causal, window, item)
FLASH = [
    (4, 4096, 4096, 24, 8, 64, True, None, 2),  # granite-moe.train-4k
    (8, 4096, 4096, 32, 32, 64, True, None, 2),  # zamba2-1.2b at 8 x 4096: its shared block
    (2, 8192, 8192, 32, 8, 80, True, 4096, 2),  # h2o-danube-1.8b train
    (2, 8192, 8192, 48, 1, 128, True, None, 2),  # granite-34b train, G 48
    (2, 8192, 8192, 6, 1, 128, True, None, 2),  # a rank's heads at model 8
    (4, 448, 1500, 20, 20, 64, False, None, 2),  # whisper cross-attention
    (4, 512, 512, 16, 4, 128, True, 64, 4),  # fp32
]
# (b, s, h, p, n, g, q, init)
SSD = [
    (8, 4096, 64, 64, 64, 1, 256, False),  # zamba2-1.2b at 8 x 4096
    (4, 4096, 64, 64, 64, 1, 256, False),  # zamba2 phase 11
    (4, 4096, 32, 64, 128, 1, 256, False),  # mamba2-370m train
    (1, 32768, 32, 64, 128, 1, 256, False),  # mamba2-370m prefill
    (4, 512, 64, 64, 64, 1, 256, True),
    (2, 300, 8, 64, 64, 2, 100, True),
]


def test_peaks():
    assert (costs.BF16_FLOPS, costs.TF32_FLOPS, costs.FP32_FLOPS, costs.HBM_BW) == (
        roofline.BF16_FLOPS, roofline.TF32_FLOPS, roofline.FP32_FLOPS, roofline.HBM_BW)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", FLASH)
def test_flash_cost(shape, backward):
    assert tuple(costs.flash_cost(*shape, backward=backward)) == tuple(
        flash_ops.cost(*shape, backward=backward))


@pytest.mark.parametrize("shape", SSD)
def test_ssd_costs(shape):
    assert tuple(costs.ssd_cost(*shape)) == tuple(ssd_ops.cost(*shape))
    for dfinal in (False, True):
        assert tuple(costs.ssd_bwd_cost(*shape, dfinal)) == tuple(ssd_ops.bwd_cost(*shape, dfinal))


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m"])
def test_configs_are_the_programs(name):
    """Each configuration file's ``arch`` is the program's config of that
    name on the day the benchmark was written; for the MoE model the
    weights a token multiplies through are the program's active count
    less the norms."""
    cfg = get_config(name)
    arch = json.loads((CONFIGS / f"{name}.json").read_text())["arch"]
    for key, value in arch.items():
        want = getattr(cfg, key)
        if key in ("moe", "ssm"):
            assert {k: getattr(want, k) for k in value} == value
        else:
            assert (list(want) if key == "pattern" else want) == value, key
    if "moe" in arch:
        norms = cfg.d_model * (1 + 2 * cfg.n_layers)
        assert costs.matmul_params_per_token(arch) == cfg.active_param_count() - norms
