"""Parity of the port's LM serving slice with the JAX package, on the CPU.

The same parameters (``convert.random_lm_tree``, numpy, seeded) and the
same token ids go through ``repro.models`` / ``repro.serve`` and through
``repro_torch.models`` / ``repro_torch.serve``, whose kernels run their
plain versions on CPU tensors.  The smoke configs are float32.
Tolerances and their reasons:

* module outputs (float32): 1e-5 relative to the output's scale plus
  1e-6 absolute.  The matmuls and reductions of the two frameworks sum in
  other orders (measured: ~1e-6 relative);
* RoPE: ``theta ** (i / half)`` and sin/cos of XLA and PyTorch may differ
  by an ulp, so the rotation is compared under the same tolerance, and in
  bf16 to one bf16 ulp (2^-8 relative);
* logits of ``forward`` and ``decode_step``: 2e-5 absolute and 1e-5
  relative (measured <= 4e-6 on logits up to ~4), tighter than the JAX
  package's own prefill/decode envelope (``tests/test_models.py``:
  ``atol=2e-4, rtol=1e-3``);
* greedy tokens: equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import attention as JA, blocks as JB, encdec as JED, layers as JL, transformer as JT
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import attention as A, layers as L, transformer as T
from repro_torch.serve import ServeEngine, build_prefill_step

torch.set_num_threads(1)

SERVE_ARCHS = ("llama3_2_1b", "qwen1_5_4b", "chatglm3_6b", "stablelm_12b", "chameleon_34b")


def _close(got, want, rel=1e-5, atol=1e-6):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + atol)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _carried(arch, seed=0):
    cfg, jcfg = smoke_config(arch), jsmoke(arch)
    tree = convert.random_lm_tree(cfg, seed)
    return cfg, jcfg, tree, convert.lm_params_from_numpy(tree, cfg, device="cpu")


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    x = _x((2, 5, 64))
    scale, bias = _x((64,), 2) + 1.0, _x((64,), 3)
    jp = {"scale": jnp.asarray(scale)} | ({"bias": jnp.asarray(bias)} if kind == "layernorm" else {})
    norm = L.init_norm(64, kind, 1e-5, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(_t(scale))
        if kind == "layernorm":
            norm.bias.copy_(_t(bias))
        _close(norm(_t(x)), JL.norm_fwd(jp, jnp.asarray(x), kind, 1e-5))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(fraction, dtype):
    pos = np.arange(3, 19, dtype=np.int32).reshape(2, 8)
    hd = 32
    js, jc = JL.rope_frequencies(int(hd * fraction), 500_000.0, jnp.asarray(pos))
    ts, tc = L.rope_frequencies(int(hd * fraction), 500_000.0, _t(pos))
    _close(ts, js)
    _close(tc, jc)
    xj = jnp.asarray(_x((2, 8, 4, hd)), dtype)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = L.apply_rope(xt, ts, tc, fraction)
    assert got.dtype == xt.dtype
    rel = 2.0**-8 if dtype == "bfloat16" else 1e-5
    _close(got, JL.apply_rope(xj, js, jc, fraction).astype(jnp.float32), rel=rel)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_jax(kind):
    ffn = L.FFN(48, 96, kind, dtype=torch.float32, device="cpu")
    L.init_weights_(ffn, torch.Generator().manual_seed(0))
    jp = {n: {"kernel": jnp.asarray(m.kernel.detach().numpy())}
          for n, m in ffn.named_children()}
    x = _x((2, 3, 48))
    with torch.no_grad():
        _close(ffn(_t(x)), JL.ffn_fwd(jp, jnp.asarray(x), kind))


def test_linear_embed_unembed_match_jax():
    lin = L.Linear(16, 24, bias=True, dtype=torch.float32, device="cpu")
    emb = L.Embedding(40, 16, dtype=torch.float32, device="cpu")
    L.init_weights_(lin, torch.Generator().manual_seed(1))
    L.init_weights_(emb, torch.Generator().manual_seed(2))
    with torch.no_grad():
        lin.bias.copy_(_t(_x((24,), 4)))
    jlin = {"kernel": jnp.asarray(lin.kernel.detach().numpy()),
            "bias": jnp.asarray(lin.bias.detach().numpy())}
    jemb = {"embedding": jnp.asarray(emb.embedding.detach().numpy())}
    x, tok = _x((3, 16)), np.array([[0, 5, 39], [7, 7, 1]], np.int32)
    with torch.no_grad():
        _close(lin(_t(x)), JL.linear(jlin, jnp.asarray(x)))
        _close(emb.embed(_t(tok)), JL.embed(jemb, jnp.asarray(tok)))
        got = emb.unembed(_t(x))
        assert got.dtype == torch.float32
        _close(got, JL.unembed(jemb, jnp.asarray(x)))
        # bf16: E^T cast to x's type, the logits rounded to bf16, then widened.
        xb = _t(x).to(torch.bfloat16)
        want = JL.unembed(jemb, jnp.asarray(xb.float().numpy(), jnp.bfloat16))
        _close(emb.unembed(xb), want, rel=2.0**-8)


# --------------------------------------------------------- attention, block


def _block_params(tree, i=0):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree["blocks"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_gqa_fresh_and_cached_match_jax(arch):
    cfg, jcfg, tree, model = _carried(arch)
    jp = _block_params(tree)["attn"]
    attn = model.blocks[0].attn
    x = _x((2, 8, cfg.d_model), scale=0.5)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    with torch.inference_mode():
        out, fresh = attn(_t(x), _t(pos))
        jout, jfresh = JA.gqa_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
        _close(out, jout)
        _close(fresh.k, jfresh.k)
        _close(fresh.v, jfresh.v)
        # One cached token against the prompt's cache (max_len 12).
        cache = A.init_gqa_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
        jcache = JA.init_gqa_cache(jcfg, 2, 12, jnp.float32)
        cache.k[:, :8], cache.v[:, :8] = fresh.k, fresh.v
        cache = cache._replace(length=8)
        jcache = JA.KVCache(k=jcache.k.at[:, :8].set(jfresh.k), v=jcache.v.at[:, :8].set(jfresh.v),
                            length=jnp.asarray(8, jnp.int32))
        x1, p1 = _x((2, 1, cfg.d_model), seed=5, scale=0.5), np.full((2, 1), 8, np.int32)
        out1, c1 = attn(_t(x1), _t(p1), cache)
        jout1, jc1 = JA.gqa_fwd(jp, jcfg, jnp.asarray(x1), jnp.asarray(p1), jcache)
        _close(out1, jout1)
        _close(c1.k, jc1.k)
        assert c1.length == int(jc1.length) == 9


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decoder_block_matches_jax(arch):
    cfg, jcfg, tree, model = _carried(arch)
    x = _x((2, 8, cfg.d_model), scale=0.5)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    with torch.inference_mode():
        out, _, aux = model.blocks[1](_t(x), _t(pos))
    jout, _, _ = JB.decoder_block_fwd(_block_params(tree, 1), jcfg, jnp.asarray(x), jnp.asarray(pos))
    assert aux is None
    _close(out, jout)


def test_cache_write_past_max_len_raises():
    cfg, _, _, model = _carried("llama3_2_1b")
    state = T.init_decode_state(cfg, 1, 8, device="cpu")
    tok = torch.zeros((1, 6), dtype=torch.int64)
    with torch.inference_mode():
        _, state = T.decode_step(model, tok, state, 0, prefill=True)
        with pytest.raises(ValueError, match="max_len"):
            T.decode_step(model, tok[:, :3], state, 6)


# ------------------------------------------------------------- transformer


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_forward_and_decode_match_jax(arch):
    """Full forward, then prefill of 8 tokens and one cached decode token."""
    cfg, jcfg, tree, model = _carried(arch)
    jp = _jtree(tree)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jfull = JT.forward(jp, jcfg, jnp.asarray(tok)).logits
    jst = JT.init_decode_state(jcfg, 2, 32)
    jl1, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, :8]), jst, jnp.asarray(0, jnp.int32),
                              prefill=True)
    jl2, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, 8:9]), jst, jnp.asarray(8, jnp.int32))
    with torch.inference_mode():
        full = T.forward(model, _t(tok)).logits
        l1, st = build_prefill_step(cfg)(model, _t(tok[:, :8]), 32)
        l2, st = T.decode_step(model, _t(tok[:, 8:9]), st, 8)
    for got, want in ((full, jfull), (l1, jl1), (l2, jl2)):
        assert got.dtype == torch.float32 and got.shape[-1] == cfg.padded_vocab
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(st["blocks"].k.numpy(), np.asarray(jst["blocks"].k), atol=2e-5,
                               rtol=1e-5)
    assert st["blocks"].length == int(jst["blocks"].length) == 9


@pytest.mark.parametrize("arch", ["llama3_2_1b", "chatglm3_6b"])
def test_greedy_generate_matches_jax(arch):
    cfg, jcfg, tree, model = _carried(arch)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(JServeEngine(jcfg, _jtree(tree), max_len=64).generate(
        jnp.asarray(prompts), n_tokens=6))
    out = ServeEngine(cfg, model, max_len=64, device="cpu").generate(_t(prompts), 6)
    np.testing.assert_array_equal(out.numpy(), want)
    # As the reference's own test: the continuation is the forward argmax.
    with torch.inference_mode():
        full = T.forward(model, out[:, :-1]).logits
    np.testing.assert_array_equal(full[:, 7:].argmax(-1).numpy(), out[:, 8:].numpy())


def test_temperature_sampling_follows_its_generator():
    cfg, _, _, model = _carried("llama3_2_1b")
    eng = ServeEngine(cfg, model, max_len=32, device="cpu")
    prompts = torch.zeros((2, 4), dtype=torch.int64)
    runs = [eng.generate(prompts, 5, temperature=1.0, generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (2, 9)
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].max()) < cfg.padded_vocab


def _leaves(tree) -> dict:
    """``{dotted path: (shape, numpy dtype)}`` of a parameter tree."""
    return {".".join(k.key for k in p): (tuple(l.shape), np.dtype(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", SERVE_ARCHS + ("rwkv6_7b", "whisper_large_v3"))
def test_random_lm_tree_matches_jax_layout(arch):
    cfg, jcfg = smoke_config(arch), jsmoke(arch)
    init = JED.init if cfg.family == "audio" else JT.init
    stack = "dec_blocks" if cfg.family == "audio" else "blocks"
    want = jax.eval_shape(lambda: init(jax.random.key(0), jcfg))
    got = convert.random_lm_tree(cfg, 0)
    assert _leaves(got) == _leaves(want)
    # Deterministic in the seed.
    leaf = ("time", "wr") if cfg.family == "ssm" else ("attn", "wq")
    again = convert.random_lm_tree(cfg, 0)[stack][leaf[0]][leaf[1]]["kernel"]
    np.testing.assert_array_equal(again, got[stack][leaf[0]][leaf[1]]["kernel"])
    # In a bf16 model every leaf has the reference's type: bf16, except
    # RWKV-6's decay_base and u_bonus, which stay float32, also after
    # lm_params_from_numpy.
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bwant = _leaves(jax.eval_shape(
        lambda: init(jax.random.key(0), dataclasses.replace(jcfg, dtype="bfloat16"))))
    types = {p: str(t).removeprefix("torch.") for p, (_, t) in convert.lm_tree_shapes(bcfg).items()}
    assert types == {p: str(t) for p, (_, t) in bwant.items()}
    f32 = {p for p, t in types.items() if t == "float32"}
    assert f32 == ({"blocks.time.decay_base", "blocks.time.u_bonus"} if cfg.family == "ssm"
                   else set())
    model = convert.lm_params_from_numpy(got, bcfg, device="cpu")
    assert {n.replace(".0.", ".", 1) for n, p in model.named_parameters()
            if p.dtype == torch.float32 and n.startswith(f"{stack}.0.")} == f32


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "rwkv6_7b", "zamba2_2_7b",
                                  "whisper_large_v3"])
def test_unported_families_raise(arch):
    """Every family of the configs builds, serves and trains: the ``ssm``,
    ``moe``, ``hybrid`` and ``audio`` families run ``lm_loss`` and a
    ``build_train_step`` step, and nothing raises but the one refusal
    left, the ``audio`` tree's (the prefill step, ``generate`` and the
    train step take the encoder frames, and its tree is ``encdec.EncDec``,
    which ``transformer.Transformer`` refuses)."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    cfg = smoke_config(arch)
    if cfg.family == "audio":
        from repro_torch.models import encdec as ED

        with pytest.raises(ValueError, match="encdec"):
            T.init(cfg, device="cpu")
        model = ED.init(cfg, device="cpu")
        tok = torch.zeros((1, 4), dtype=torch.int64)
        frames = torch.zeros((1, cfg.encdec.encoder_seq, cfg.d_model))
        with torch.inference_mode():
            logits, state = build_prefill_step(cfg)(model, tok, frames, 8)
        assert logits.shape == (1, 4, cfg.padded_vocab) and state.self_kv.length == 4
        out = ServeEngine(cfg, model, max_len=8, device="cpu").generate(tok, 3, frames=frames)
        assert out.shape == (1, 7)
        step = build_train_step(cfg, AdamWConfig())
        _, _, metrics = step(model, adamw_init(dict(model.named_parameters()), AdamWConfig()),
                             {"tokens": tok, "labels": tok, "frames": frames}, 0)
        assert math.isfinite(float(metrics["loss"]))
        return
    model = T.init(cfg, device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with torch.inference_mode():
        assert build_prefill_step(cfg)(model, tok, 8)[0].shape == (1, 4, cfg.padded_vocab)
    assert cfg.family in ("ssm", "moe", "hybrid")
    assert torch.isfinite(T.lm_loss(model, tok, tok)[0])
    step = build_train_step(cfg, AdamWConfig())
    _, _, metrics = step(model, adamw_init(dict(model.named_parameters()), AdamWConfig()),
                         {"tokens": tok, "labels": tok}, 0)
    assert math.isfinite(float(metrics["loss"]))


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "chameleon-34b", "--requests", "2", "--prompt-len", "5",
                "--gen-tokens", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("req0: [")
