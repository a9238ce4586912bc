"""The zamba2 reference against transformers' own ``Zamba2ForCausalLM``
(``use_mem_rope``, ``use_shared_attention_adapter``, one memory block) on
the same weights: this pins the reference's layer equations to the
published code.  Skips where transformers is not installed.

The sequence is one SSD chunk long: transformers' CPU path of the Mamba2
mixer (``torch_forward``, 4.57.6) sums the decay of the state carried from
chunk to chunk over the wrong chunk index, so past one chunk it is not the
recurrence (the published model runs ``mamba_ssm``'s kernels on a GPU).
The reference's chunked scan is held to the sequential recurrence across
chunks by a test of its own here."""

import math
import os

import pytest
import torch

from portbench import weights
from portbench.reference import common, mamba2_hybrid, zamba2

# two periods and a tail: two hybrid calls, each with its own adapters
ARCH = {"family": "hybrid", "n_layers": 14, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "head_dim": 32, "d_ff": 128, "vocab_size": 256, "pattern": ["mamba"] * 5 + ["hybrid"],
        "rope_theta": 10000.0, "norm_eps": 1e-5, "tie_embeddings": True,
        "adapter_rank": 8, "param_dtype": "float32", "compute_dtype": "float32",
        "ssm": {"d_state": 16, "head_dim": 16, "expand": 2, "n_groups": 1, "conv_width": 4,
                "chunk": 64}}
SEQ = 48  # under one chunk (see above); transformers pads it to 64
#: fp32 on both sides; only the order of sums differs (the SSD's quadratic
#: form, the attention in query blocks here)
RTOL = 1e-4


@pytest.fixture(scope="module")
def transformers():
    os.environ.setdefault("USE_TF", "0")
    return pytest.importorskip("transformers")


def hf_model(transformers, arch):
    s = arch["ssm"]
    cfg = transformers.Zamba2Config(
        vocab_size=arch["vocab_size"], hidden_size=arch["d_model"],
        num_hidden_layers=arch["n_layers"], layers_block_type=common.layer_kinds(arch),
        mamba_d_state=s["d_state"], mamba_d_conv=s["conv_width"], mamba_expand=s["expand"],
        mamba_ngroups=s["n_groups"], n_mamba_heads=s["expand"] * arch["d_model"] // s["head_dim"],
        chunk_size=s["chunk"], intermediate_size=arch["d_ff"], hidden_act="gelu",
        num_attention_heads=arch["n_heads"], num_key_value_heads=arch["n_kv_heads"],
        num_mem_blocks=1, use_shared_attention_adapter=True, adapter_rank=arch["adapter_rank"],
        use_mem_rope=True, rope_theta=arch["rope_theta"], rms_norm_eps=arch["norm_eps"],
        tie_word_embeddings=False, attn_implementation="eager")
    assert cfg.attention_head_dim == arch["head_dim"]
    model = transformers.Zamba2ForCausalLM(cfg).eval()
    for mod in model.modules():
        if hasattr(mod, "time_step_min"):
            # the program does not clamp dt below: softplus(.) > 0 makes a floor of 0 a no-op
            mod.time_step_min = 0.0
    return model


def load(model, params, arch):
    """The reference's tree into transformers' modules: (1 + scale) as each
    norm's weight; z, x, [B ; C] and dt concatenated as ``in_proj``; the conv
    taps [W, ch] as [ch, 1, W]; the embedding table x sqrt(d) as the
    input embedding and the table itself as an untied ``lm_head``."""
    v, d = arch["vocab_size"], arch["d_model"]
    pattern = arch["pattern"]
    g = arch["n_layers"] // len(pattern)
    sd = {}

    def lin(name, w):  # [in, out] -> torch's [out, in]
        sd[name] = w.t()

    def norm(name, scale):
        sd[name] = 1.0 + scale

    table = params["embed"]["table"][:v]
    sd["model.embed_tokens.weight"] = table * math.sqrt(d)
    sd["lm_head.weight"] = table
    norm("model.final_layernorm.weight", params["final_norm"]["scale"])
    call, hybrids = 0, []
    for i, kind in enumerate(common.layer_kinds(arch)):
        if i < g * len(pattern):
            p = {k: v_[i // len(pattern)] for k, v_ in
                 common.flatten(params["groups"][f"pos{i % len(pattern)}"])}
        else:
            p = dict(common.flatten(params["tail"][f"pos{i - g * len(pattern)}"]))
        pre = f"model.layers.{i}." + ("mamba_decoder." if kind == "hybrid" else "")
        norm(pre + "input_layernorm.weight", p["ln1/scale"])
        mx = pre + "mamba."
        lin(mx + "in_proj.weight", torch.cat([p[f"mamba/{n}/w"] for n in
                                              ("z_proj", "x_proj", "bc_proj", "dt_proj")], 1))
        sd[mx + "conv1d.weight"] = torch.cat([p["mamba/conv_x_w"], p["mamba/conv_bc_w"]],
                                             1).t()[:, None]
        sd[mx + "conv1d.bias"] = torch.cat([p["mamba/conv_x_b"], p["mamba/conv_bc_b"]])
        for n in ("A_log", "D", "dt_bias"):
            sd[mx + n] = p[f"mamba/{n}"]
        norm(mx + "norm.weight", p["mamba/gate_norm/scale"])
        lin(mx + "out_proj.weight", p["mamba/out_proj/w"])
        if kind != "hybrid":
            continue
        lin(f"model.layers.{i}.linear.weight", p["linear/w"])
        for n in ("q", "k", "v"):
            for j, part in enumerate(("down", "up")):
                lin(f"shared.self_attn.linear_{n}_adapter_list.{call}.{j}.weight",
                    p[f"lora/{n}/{part}/w"])
        for j, part in enumerate(("down", "up")):
            lin(f"shared.feed_forward.gate_up_proj_adapter_list.{call}.{j}.weight",
                p[f"lora/gate_up/{part}/w"])
        hybrids.append(i)
        call += 1
    shared = params["shared"]
    for n in ("q", "k", "v", "o"):
        lin(f"shared.self_attn.{n}_proj.weight", shared["attn"][n]["w"])
    lin("shared.feed_forward.gate_up_proj.weight", shared["mlp"]["gate_up"]["w"])
    lin("shared.feed_forward.down_proj.weight", shared["mlp"]["down"]["w"])
    norm("shared.input_layernorm.weight", shared["ln1"]["scale"])
    norm("shared.pre_ff_layernorm.weight", shared["ln2"]["scale"])
    # the one shared module sits under every hybrid layer's name
    for key in [k for k in sd if k.startswith("shared.")]:
        t = sd.pop(key)
        for i in hybrids:
            sd[f"model.layers.{i}.shared_transformer.{key[len('shared.'):]}"] = t
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd and not k.endswith("inv_freq"))
    assert not missing, missing[:8]
    res = model.load_state_dict({k: t.detach().clone().contiguous() for k, t in sd.items()},
                                strict=False)
    assert not res.unexpected_keys, res.unexpected_keys[:8]


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_matches_transformers(transformers, seed):
    torch.manual_seed(seed % 2**31)
    params = weights.make_params(zamba2.param_shapes(ARCH), seed, "cpu", fp32=True)
    # norm scales and conv biases are drawn as 0: give them values, so that
    # (1 + scale) and the biases are tested
    for path, t in common.flatten(params):
        if path.endswith(("scale", "_b")):
            t.normal_(0.0, 0.1)
    tokens = torch.randint(0, ARCH["vocab_size"], (2, SEQ))
    model = hf_model(transformers, ARCH)
    load(model, params, ARCH)
    with torch.no_grad():
        want = model(input_ids=tokens.long(), use_cache=False).logits
        x = zamba2.hidden(params, tokens, ARCH, common.Numerics())
        got = x @ params["embed"]["table"][: ARCH["vocab_size"]].t()
    err = (got - want).abs().max() / want.abs().max()
    assert err < RTOL, float(err)


@pytest.mark.parametrize("chunk", [16, 7])
def test_chunked_scan_is_the_recurrence(chunk):
    """``mamba2_hybrid.ssd`` over several chunks against h_t = exp(dA_t)
    h_{t-1} + x_t B_t^T, y_t = h_t C_t, step by step, in fp32."""
    gen = torch.Generator().manual_seed(chunk)
    b, s, h, p, g, n = 2, 4 * chunk, 4, 8, 2, 6
    x = torch.randn(b, s, h, p, generator=gen)
    dA = -torch.rand(b, s, h, generator=gen)
    B, C = torch.randn(2, b, s, g, n, generator=gen)
    got = mamba2_hybrid.ssd(x, dA, B, C, chunk)
    Bh, Ch = (t.repeat_interleave(h // g, dim=2) for t in (B, C))
    state, want = torch.zeros(b, h, p, n), []
    for t in range(s):
        state = state * dA[:, t].exp()[..., None, None] + x[:, t, ..., None] * Bh[:, t, :, None]
        want.append((state * Ch[:, t, :, None]).sum(-1))
    want = torch.stack(want, 1)
    assert (got - want).abs().max() <= RTOL * want.abs().max()
