"""Parity of the port's RWKV-6 serving slice (the ``ssm`` family) with the
JAX package, on the CPU.

The same seeded numpy inputs and weights (``convert.random_lm_tree``) go
through ``repro.kernels`` / ``repro.models`` / ``repro.serve`` and through
``repro_torch``, whose ``rwkv6_scan`` runs its plain versions on CPU
tensors (the sequential scan, or the chunk-parallel form by the
reference's host rule).  On the JAX side the Pallas kernel runs in
interpret mode (``force="pallas"``).  bf16 inputs are rounded once in
PyTorch and carried across exactly.  Tolerances and their reasons:

* the recurrence in float32: 1e-5 of the output's largest value.  Both
  sides sum the same float32 products in other orders (measured: at most
  7.2e-7 of the largest value, on outputs up to 13 and states up to 2.7);
* its bf16 output: one bf16 ulp of the element (2^-7 of it) on top of
  that, since each side rounds a float32 value that differs in its last
  bits once (measured: 0.0156 on an element of 2-4); the state stays
  float32 (1e-5);
* the chunked form against the sequential scan (extreme decays): the
  reference's own envelope, 2e-4 absolute and 1e-3 relative;
* module outputs and logits in float32: 2e-5 of the largest value plus
  1e-6 (measured: at most 3.8e-6 of it; matmuls, the chunked form's
  einsums and the norms sum in other orders);
* module outputs in bf16: 2^-6 of the largest value.  Both packages round
  at the same points, but their bf16 matmuls sum in other orders, so an
  intermediate may land one bf16 ulp (2^-8 relative) apart, and the time
  mix chains about four such roundings (measured: at most 0.0075 of the
  largest value, just under 2^-7);
* greedy tokens: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.kernels import ops as jops, ref as jref
from repro.models import rwkv6 as JR, transformer as JT
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref, rwkv6_scan as rw
from repro_torch.models import rwkv6 as R, transformer as T
from repro_torch.serve import ServeEngine, build_prefill_step
from test_torch_serve_reference import jax_params

torch.set_num_threads(1)

ARCH = "rwkv6_7b"
SCAN_SHAPES = [(2, 3, 200, 64, 64), (1, 2, 64, 128, 64), (1, 1, 257, 64, 128)]


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(np.asarray(x, np.float32), np.float64)


def _close(got, want, rel=2e-5, atol=1e-6, ulp=0.0):
    """|got - want| <= ulp |want| + rel max|want| + atol, elementwise."""
    g, w = _f64(got), _f64(want)
    assert g.shape == w.shape
    bound = ulp * np.abs(w) + rel * (float(np.max(np.abs(w))) or 1.0) + atol
    worst = float(np.max(np.abs(g - w) - bound))
    assert worst <= 0, f"max |diff| {np.max(np.abs(g - w))!r} exceeds its bound by {worst!r}"


def _scan_inputs(b, h, t, d, dtype, seed=0):
    """``(torch, jax)`` copies of ``r, k, v, w, u`` as the reference's test
    draws them (decays in [0.45, 0.95])."""
    g = np.random.default_rng(seed)
    r, k, v = (g.standard_normal((b, h, t, d)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-g.standard_normal((b, h, t, d)))) * 0.5 + 0.45).astype(np.float32)
    u = (g.standard_normal((h, d)) * 0.3).astype(np.float32)
    ts = [torch.from_numpy(a).to(dtype) for a in (r, k, v, w, u)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ts, [jnp.asarray(x.float().numpy()).astype(jdt) for x in ts]


def _scan_close(got, want, dtype):
    (o, s), (jo, js) = got, want
    assert o.dtype == dtype and s.dtype == torch.float32
    _close(o, jo, rel=1e-5, atol=0.0, ulp=2.0**-7 if dtype == torch.bfloat16 else 0.0)
    _close(s, js, rel=1e-5, atol=0.0)


# -------------------------------------------------------------- the scan


@pytest.mark.parametrize("b,h,t,d,block_t", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_scan_matches_jax_ref_and_pallas(b, h, t, d, block_t, dtype):
    ts, js = _scan_inputs(b, h, t, d, dtype)
    got = ref.rwkv6_scan(*ts)
    _scan_close(got, jref.rwkv6_scan(*js), dtype)
    _scan_close(got, jops.rwkv6_scan(*js, force="pallas", block_t=block_t), dtype)
    # The chunk-parallel form (the sequential scan where T is ragged or a
    # single chunk, as in the reference).
    _scan_close(ref.rwkv6_chunked(*ts), jref.rwkv6_chunked(*js), dtype)


def test_state_carry_matches_one_pass():
    """Two calls with the state carried equal one call (the decode
    contract), through both plain forms, and match JAX's carried scan."""
    ts, js = _scan_inputs(1, 2, 128, 64, torch.float32, seed=10)
    full = ops.rwkv6_scan(*ts)
    jfull = jref.rwkv6_scan(*js)
    for algorithm in ("auto", "sequential"):  # chunked halves (64 = 2 chunks), then sequential
        o1, s1 = ops.rwkv6_scan(*(x[:, :, :64] for x in ts[:4]), ts[4], algorithm=algorithm)
        o2, s2 = ops.rwkv6_scan(*(x[:, :, 64:] for x in ts[:4]), ts[4], s1, algorithm=algorithm)
        _close(torch.cat([o1, o2], dim=2), full[0], rel=1e-5, atol=0.0)
        _close(s2, full[1], rel=1e-5, atol=0.0)
    _, js1 = jops.rwkv6_scan(*(x[:, :, :64] for x in js[:4]), js[4], force="pallas", block_t=32)
    _, js2 = jops.rwkv6_scan(*(x[:, :, 64:] for x in js[:4]), js[4], js1, force="pallas",
                             block_t=32)
    _close(s2, js2, rel=1e-5, atol=0.0)
    _close(full[0], jfull[0], rel=1e-5, atol=0.0)


@pytest.mark.parametrize("w_val,accurate", [(0.9999, True), (0.5, True), (0.3, True),
                                            (0.01, False)])
def test_chunked_extreme_decays(w_val, accurate):
    """The chunked form under the reference's adversarial decays: finite
    everywhere, equal to JAX's chunked form, and accurate against the
    sequential scan within the reference's envelope where the reference
    claims it (mean per-step decay >= ~0.29 at chunk 32)."""
    ts, js = _scan_inputs(1, 2, 256, 64, torch.float32, seed=42)
    ts[3] = torch.full_like(ts[3], w_val)
    js[3] = jnp.full(js[3].shape, w_val, jnp.float32)
    o, s = ref.rwkv6_chunked(*ts, chunk=32)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    jo, js_ = jref.rwkv6_chunked(*js, chunk=32)
    _close(o, jo, rel=1e-5, atol=0.0)
    _close(s, js_, rel=1e-5, atol=0.0)
    if accurate:
        o_seq, _ = ref.rwkv6_scan(*ts)
        np.testing.assert_allclose(o.numpy(), o_seq.numpy(), atol=2e-4, rtol=1e-3)


def test_cpu_dispatch_rule():
    """CPU tensors take the plain versions by the reference's host rule."""
    ts, _ = _scan_inputs(1, 2, 96, 64, torch.float32, seed=3)
    short = [x[:, :, :40] for x in ts[:4]] + [ts[4]]
    one = [x[:, :, :1] for x in ts[:4]] + [ts[4]]
    chunk = [x[:, :, :32] for x in ts[:4]] + [ts[4]]
    assert all(torch.equal(a, b) for a, b in zip(ops.rwkv6_scan(*ts), ref.rwkv6_chunked(*ts)))
    for args in (short, one, chunk):
        assert all(torch.equal(a, b) for a, b in zip(ops.rwkv6_scan(*args), ref.rwkv6_scan(*args)))
    seq = ops.rwkv6_scan(*ts, algorithm="sequential", force="ref")
    assert all(torch.equal(a, b) for a, b in zip(seq, ref.rwkv6_scan(*ts)))
    with ops.forced("ref"):
        assert torch.equal(ops.rwkv6_scan(*ts)[0], ref.rwkv6_chunked(*ts)[0])
    # A block's algorithm reaches the calls that leave theirs at "auto".
    with ops.forced("ref", algorithm="sequential"):
        assert all(torch.equal(a, b) for a, b in zip(ops.rwkv6_scan(*ts), ref.rwkv6_scan(*ts)))
    assert torch.equal(ops.rwkv6_scan(*ts)[0], ref.rwkv6_chunked(*ts)[0])
    with pytest.raises(ValueError, match="algorithm"):
        ops.rwkv6_scan(*ts, algorithm="chunked")
    with pytest.raises(ValueError, match="algorithm"), ops.forced("ref", algorithm="chunked"):
        pass
    with pytest.raises(ValueError, match="CUDA"):
        ops.rwkv6_scan(*ts, force="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rw.rwkv6_scan(*ts)
    assert rw.rwkv6_scan.launches == 0


def test_kernel_path_wiring(monkeypatch):
    """With the launch replaced by a plain stand-in: the kernel path gets
    the operands as given (no fallback, no algorithm choice) and refuses a
    recording autograd graph; the plain path is differentiable."""
    ts, _ = _scan_inputs(1, 2, 64, 64, torch.float32, seed=4)
    calls = []

    def stand_in(r, k, v, w, u, state0=None):
        calls.append(r.shape)
        return ref.rwkv6_scan(r, k, v, w, u, state0)

    monkeypatch.setattr(ops, "_use_kernel", lambda t, force: True)
    monkeypatch.setattr(ops._rw, "rwkv6_scan", stand_in)
    o, _ = ops.rwkv6_scan(*ts)
    assert calls == [ts[0].shape] and torch.equal(o, ref.rwkv6_scan(*ts)[0])
    r = ts[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.rwkv6_scan(r, *ts[1:])
    with torch.no_grad():
        ops.rwkv6_scan(r, *ts[1:])
    monkeypatch.undo()
    o, _ = ops.rwkv6_scan(r, *ts[1:])
    (g,) = torch.autograd.grad(o.sum(), r)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


# -------------------------------------------------------------- the model


def _cfgs(dtype="float32"):
    return (dataclasses.replace(smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(jsmoke(ARCH), dtype=dtype))


def _carried(dtype="float32", seed=0):
    cfg, jcfg = _cfgs(dtype)
    tree = convert.random_lm_tree(cfg, seed)
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    return cfg, jcfg, model, jax_params(tree, jcfg)


def _x(shape, seed, dtype):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))


def _states(cfg, b, seed, dtype):
    """A random layer state (the port's and JAX's)."""
    h, hd = R.heads(cfg)
    tm, jtm = _x((b, 1, cfg.d_model), seed, dtype)
    cm, jcm = _x((b, 1, cfg.d_model), seed + 1, dtype)
    wkv, jwkv = _x((b, h, hd, hd), seed + 2, "float32")
    return (R.RWKVState(tm, cm, wkv, 5),
            JR.RWKVState(jtm, jcm, jwkv, jnp.asarray(5, jnp.int32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,with_state", [(64, False), (64, True), (7, True), (1, True)])
def test_mixes_and_block_match_jax(dtype, t, with_state):
    """Time mix, channel mix and the whole block of layer 1, fresh and from
    a carried state, at the smoke width on the same numpy weights (64
    tokens take both packages' chunked forms; 7 and 1 the sequential)."""
    cfg, jcfg, model, jp = _carried(dtype)
    blk, jb = model.blocks[1], jax.tree.map(lambda a: a[1], jp["blocks"])
    assert blk.time.decay_base.dtype == torch.float32 and blk.time.u_bonus.dtype == torch.float32
    x, jx = _x((2, t, cfg.d_model), 7, dtype)
    st, jst = _states(cfg, 2, 11, dtype) if with_state else (None, None)
    rel = 2.0**-6 if dtype == "bfloat16" else 2e-5
    with torch.inference_mode():
        tm, shift, wkv = blk.time(x, st)
        cm, cshift = blk.channel(x, st)
        out, ns = blk(x, st)
    jtm, jshift, jwkv = JR.time_mix_fwd(jb["time"], jcfg, jx, jst)
    jcm, jcshift = JR.channel_mix_fwd(jb["channel"], jcfg, jx, jst)
    jout, jns = JR.rwkv6_block_fwd({"time": jb["time"], "channel": jb["channel"]}, jcfg, jx,
                                   {"ln1": jb["ln1"], "ln2": jb["ln2"]}, jst)
    assert tm.dtype == x.dtype and wkv.dtype == torch.float32
    for got, want in ((tm, jtm), (wkv, jwkv), (cm, jcm), (out, jout), (ns.wkv, jns.wkv),
                      (ns.shift_tm, jns.shift_tm), (ns.shift_cm, jns.shift_cm)):
        _close(got, want, rel=rel)
    assert torch.equal(shift, x[:, -1:]) and torch.equal(cshift, x[:, -1:])
    assert ns.length == int(jns.length) == t + (5 if with_state else 0)


def test_forward_prefill_and_decode_match_jax():
    """``forward`` over 64 tokens; the prefill step on a 64-token prompt,
    then three single-token decode steps; the stacked state after them."""
    cfg, jcfg, model, jp = _carried()
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 67)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.array(a)).long()
    with torch.inference_mode():
        full = T.forward(model, t(tok[:, :64])).logits
        logits, st = build_prefill_step(cfg)(model, t(tok[:, :64]), 80)
        steps = [logits]
        for i in range(64, 67):
            logits, st = T.decode_step(model, t(tok[:, i:i + 1]), st, i)
            steps.append(logits)
    jfull = JT.forward(jp, jcfg, jnp.asarray(tok[:, :64])).logits
    jst = JT.init_decode_state(jcfg, 2, 80)
    jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, :64]), jst, jnp.asarray(0, jnp.int32),
                             prefill=True)
    jsteps = [jl]
    for i in range(64, 67):
        jl, jst = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, i:i + 1]), jst,
                                 jnp.asarray(i, jnp.int32))
        jsteps.append(jl)
    assert full.dtype == torch.float32 and full.shape == (2, 64, cfg.padded_vocab)
    _close(full, jfull)
    for got, want in zip(steps, jsteps):
        _close(got, want)
    jb = jst["blocks"]
    for got, want in ((st["blocks"].wkv, jb.wkv), (st["blocks"].shift_tm, jb.shift_tm),
                      (st["blocks"].shift_cm, jb.shift_cm)):
        _close(got, want)
    assert st["blocks"].wkv.shape == (cfg.n_layers, 2, *R.heads(cfg), R.heads(cfg)[1])
    assert st["blocks"].length == int(jb.length) == 67


def test_decode_over_a_sequence_equals_one_forward_pass():
    """The state carried across a 64-token prompt and 8 single tokens gives
    the logits of one fresh pass over the 72 tokens (the prompt takes the
    chunked form, the fresh pass of 72 tokens the sequential one)."""
    cfg, _, model, _ = _carried(seed=1)
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 72)))
    with torch.inference_mode():
        full = T.forward(model, tok).logits
        st = T.init_decode_state(cfg, 3, 0, device="cpu")
        logits, st = T.decode_step(model, tok[:, :64], st, 0)
        got = [logits]
        for i in range(64, 72):
            logits, st = T.decode_step(model, tok[:, i:i + 1], st, i)
            got.append(logits)
    _close(torch.cat(got, dim=1), full)


def test_greedy_generate_matches_jax():
    cfg, jcfg, model, jp = _carried()
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want = np.asarray(JServeEngine(jcfg, jp, max_len=64).generate(jnp.asarray(prompts),
                                                                  n_tokens=6))
    out = ServeEngine(cfg, model, max_len=64, device="cpu").generate(
        torch.from_numpy(prompts).long(), 6)
    np.testing.assert_array_equal(out.numpy(), want)
    with torch.inference_mode():
        full = T.forward(model, out[:, :-1]).logits
    np.testing.assert_array_equal(full[:, 31:].argmax(-1).numpy(), out[:, 32:].numpy())


def test_serve_launcher_runs_rwkv6_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "rwkv6-7b", "--requests", "2", "--prompt-len", "5",
                "--gen-tokens", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("req0: [") and lines[1].startswith("req1: [")
