import pytest

from portbench.tests.tiny import HYBRID_ARCH, MOE_ARCH


@pytest.fixture(params=[MOE_ARCH, HYBRID_ARCH], ids=["moe_transformer", "mamba2_hybrid"])
def arch(request):
    return request.param
