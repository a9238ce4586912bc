"""How a stacked group's weights leave their stacked leaves: one ``unbind``
of each leaf a call (``transformer._group_unbind``) against an index select
of each leaf a group (``transformer._group_slice``, the path it replaced,
rebuilt here), on the CPU.

For a MoE model (granite-moe-3b-a800m-smoke in bf16, the benchmark cell's
dtypes), a dense pattern with a tail (gemma3-1b-smoke at 13 layers), a
hybrid whose shared block recurs in two groups (zamba2-1.2b-smoke at 14
layers) and the encoder-decoder (whisper-large-v3-smoke), each with remat on
and off:

* ``loss_fn``'s loss and every gradient of ``torch.autograd.grad`` equal the
  select path's by ``torch.equal``: the unbind's backward stacks the same
  per-group gradients that the selects' backward scattered into zeros and
  added, and adding zeros is exact;
* the autograd graph from the loss holds one ``UnbindBackward0`` per
  stacked leaf, whose input is that leaf, and no ``SelectBackward0`` whose
  input is a stacked leaf.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import flatten_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, transformer, whisper  # noqa: E402

BATCH, SEQ = 2, 32
#: (config, overrides, the top-level keys of the stacked leaves)
CASES = {
    "moe": ("granite-moe-3b-a800m-smoke",
            dict(n_layers=4, n_heads=6, n_kv_heads=2, param_dtype="bfloat16",
                 compute_dtype="bfloat16"), ("groups",)),
    "dense": ("gemma3-1b-smoke", dict(n_layers=13), ("groups",)),
    "hybrid": ("zamba2-1.2b-smoke", dict(n_layers=14), ("groups",)),
    "encdec": ("whisper-large-v3-smoke", dict(n_layers=3), ("encoder", "decoder")),
}


def _setup(case):
    name, overrides, stacked = CASES[case]
    cfg = dataclasses.replace(get_config(name), **overrides)
    api = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen)
             for k in ("tokens", "labels")}
    if cfg.encdec is not None:
        batch["frames"] = torch.randn((BATCH, cfg.encdec.n_frames, cfg.d_model), generator=gen)
    return api, batch, stacked


def _sliced(tree, n):
    """The path before ``_group_unbind``: an index select a leaf a group."""
    return [transformer._group_slice(tree, i) for i in range(n)]


def _loss_and_grads(api, batch, remat):
    """(loss, graph's node types by the stacked leaf they feed, grads)."""
    params = api.init(seed=0)
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    loss, _ = api.loss_fn(params, batch, remat=remat)
    edges = _edges_into_leaves(loss.grad_fn, {id(t): p for p, t in leaves})
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return loss.detach(), edges, dict(zip([p for p, _ in leaves], grads))


def _edges_into_leaves(root, paths):
    """{leaf path: [the type names of the nodes whose input is that leaf]}."""
    seen, todo, out = set(), [root], {}
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in paths:
                out.setdefault(paths[id(var)], []).append(type(node).__name__)
            todo.append(nxt)
    return out


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("case", list(CASES))
def test_unbind_gradients_equal_selects(case, remat, monkeypatch):
    api, batch, stacked = _setup(case)
    loss, edges, grads = _loss_and_grads(api, batch, remat)
    with monkeypatch.context() as m:
        m.setattr(transformer, "_group_unbind", _sliced)
        m.setattr(whisper, "_group_unbind", _sliced)
        loss_ref, edges_ref, grads_ref = _loss_and_grads(api, batch, remat)

    assert torch.equal(loss, loss_ref)
    assert list(grads) == list(grads_ref)
    for path, g in grads.items():
        r = grads_ref[path]
        assert (g is None) == (r is None), path
        if g is not None:
            assert g.dtype == r.dtype and torch.equal(g, r), path

    stacked_paths = [p for p in grads if p.split("/")[0] in stacked]
    assert stacked_paths
    for p in stacked_paths:
        # one unbind node for the whole leaf, no select of it
        assert edges[p] == ["UnbindBackward0"], (p, edges[p])
        assert edges_ref[p] == ["SelectBackward0"] * grads[p].shape[0], p
