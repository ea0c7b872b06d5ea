"""Parity of the port's ``audio`` family (the Whisper encoder-decoder,
``repro_torch.models.encdec``) with the JAX package's
``repro.models.encdec``, on the CPU.

The same parameters (``convert.random_lm_tree``, numpy, seeded), frames and
token ids go through both packages; the port's flash kernel runs its plain
version on CPU tensors, as the JAX package runs its jnp path there.  The
whisper smoke config (2 encoder and 2 decoder layers, d_model 128, 4 heads
of 32, 64 frames) runs in float32 and in bf16.  Tolerances and their
reasons:

* float32 module outputs: 1e-5 relative to the output's scale plus 1e-6
  absolute, as ``tests/test_torch_models.py`` (the two frameworks' matmuls,
  softmax and layernorm sum in other orders); logits 2e-5 absolute and
  1e-5 relative; the loss 1e-5 relative; gradients 1e-4 of each leaf's
  scale;
* bf16 modules called alone (the reference run op by op): 2^-7 of the
  output's scale, two bf16 ulps at its largest value.  Every operation
  rounds where the reference's code does (the GELU per operation,
  ``layers.gelu``; the attention logits before they are widened), but a
  bf16 matmul accumulated in another order may round to the neighbouring
  value, and one such ulp moves what follows;
* bf16 outputs of the whole model (``encode``, ``forward``, the decode
  steps and their caches), where the reference runs its blocks compiled
  (``lax.scan``): 2^-5 of the output's scale.  Compiled, XLA folds the
  ``astype(float32)`` after the logits einsum into the product, so the
  reference's compiled attention keeps its logits in float32, where its
  op-by-op run (and the port, which rounds as the code is written) rounds
  them to bf16: 57 % of an encoder block's outputs lie a bf16 ulp apart
  between the reference's own compiled and op-by-op runs;
* the sinusoidal positions: see ``test_sinusoids_match_jax``;
* the training frames: bit for bit.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import encdec as JED
from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as jadamw_init
from repro.serve import ServeEngine as JServeEngine
from repro.train.step import build_train_step as jbuild_train_step
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import encdec as ED, layers as L, transformer as T
from repro_torch.optim import AdamWConfig, adamw, adamw_init
from repro_torch.serve import ServeEngine, build_decode_step, build_prefill_step
from repro_torch.train import build_train_step
from repro_torch.train.loop import audio_frames

torch.set_num_threads(1)

ARCH = "whisper_large_v3"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2.0**-7, 0.0)}
STACK_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2.0**-5, 0.0)}
LOGIT_TOL = {"float32": (1e-5, 2e-5), "bfloat16": (2.0**-5, 0.0)}


def _close(got, want, rel, atol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32)) if not isinstance(
        want, np.ndarray) else want.astype(np.float32)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + atol)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(jsmoke(ARCH), dtype=dtype))


def _carried(dtype="float32", seed=0):
    cfg, jcfg = _cfgs(dtype)
    tree = convert.random_lm_tree(cfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.dtype(dtype)), tree)
    return cfg, jcfg, jp, convert.lm_params_from_numpy(tree, cfg, device="cpu")


def _frames(cfg, b=2, seed=5):
    """``(numpy float32, jax, torch)`` frames of the config's type, the same
    bits on both sides."""
    x = (np.random.default_rng(seed).standard_normal((b, cfg.encdec.encoder_seq, cfg.d_model))
         * 0.5).astype(np.float32)
    j = jnp.asarray(x, jnp.dtype(cfg.dtype))
    return x, j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(L.dtype_of(cfg))


def _tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _jpositions(b, t):
    return jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None], (b, t))


# ----------------------------------------------------------------- layers


def _jax_pe(t, d):
    """``repro.models.encdec.encode``'s positions (``encdec.py:140-143``),
    its expression as written there."""
    pos = jnp.arange(t)[:, None]
    dim = jnp.arange(d // 2)[None, :]
    inv = jnp.exp(-math.log(10000.0) * dim / (d // 2))
    return jnp.concatenate([jnp.sin(pos * inv), jnp.cos(pos * inv)], axis=-1)


@pytest.mark.parametrize("shape", [(64, 128), (1500, 1280)])
def test_sinusoids_match_jax(shape):
    """``sinusoids`` against the reference's expression, eager and jitted:
    float32 within 1.25e-4 absolute (a float32 ulp of the angle near 1499
    rad is 1.22e-4; XLA's ``exp``/``sin`` lie within an ulp of the
    correctly rounded ones, and under ``jit`` it reassociates the
    exponent's argument: its own eager and jitted positions differ by as
    much); at the smoke shape within 2e-6.  Cast to bf16 (as ``encode``
    adds them) they agree but for at most 0.2 % of the elements, each
    within the float32 tolerance plus a bf16 ulp (measured: 0 of 8192 at
    the smoke shape, 781 eager and 3170 jitted of 1.92 M at whisper's)."""
    t, d = shape
    got = ED.sinusoids(t, d, "cpu")
    assert got.dtype == torch.float32 and got.shape == (t, d)
    gb = got.to(torch.bfloat16).float().numpy()
    for jf in (_jax_pe, jax.jit(_jax_pe, static_argnums=(0, 1))):
        want = np.asarray(jf(t, d))
        tol = 2e-6 if t == 64 else 1.25e-4
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
        wb = np.asarray(jnp.asarray(want, jnp.bfloat16).astype(jnp.float32))
        off = gb != wb
        assert off.mean() <= 2e-3 and (t > 64 or not off.any())
        # A bf16 ulp of the larger of the two (they may straddle a power of
        # 2) beyond the float32 tolerance (near zero that tolerance spans
        # many bf16 ulps).
        ulp = np.spacing(np.maximum(np.abs(wb), np.abs(gb)).astype(np.float32)) * 2.0**16
        assert (np.abs(gb - wb) <= tol + ulp).all()
    # The same bits on any device: float64 arithmetic rounded after each step.
    np.testing.assert_array_equal(got.numpy(), ED.sinusoids(t, d, "cpu").numpy())


def test_gelu_matches_jax_bitwise_in_bf16():
    """``layers.gelu`` rounds each operation as XLA does: bit for bit
    ``jax.nn.gelu`` in bf16 over 2e5 values (``F.gelu`` differs in ~43 %
    of them); float32 within 1e-6 absolute (XLA's float32 ``tanh`` is its
    own approximation: measured 5.8e-7 at values up to ~10)."""
    x = (np.random.default_rng(4).standard_normal(200_000) * 3).astype(np.float32)
    jb = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tb = L.gelu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(tb, jb)
    jf = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(L.gelu(torch.from_numpy(x)).numpy(), jf, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_block_matches_jax(dtype):
    """The bidirectional block (layernorm, non-causal attention, the GELU
    FFN) on frames, layer 1's weights."""
    cfg, jcfg, jp, model = _carried(dtype)
    _, jx, tx = _frames(cfg)
    b, t = tx.shape[:2]
    want = JED.encoder_block_fwd(_layer(jp["enc_blocks"], 1), jcfg, jx, _jpositions(b, t))
    with torch.no_grad():
        got, _, aux = model.enc_blocks[1](tx, torch.arange(t).expand(b, t))
    assert aux is None and got.dtype == L.dtype_of(cfg)
    _close(got, want, *TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax_both_branches(dtype):
    """From the memory (its keys and values projected) and from the
    precomputed K/V: the output and the K/V each."""
    cfg, jcfg, jp, model = _carried(dtype)
    _, jm, tm = _frames(cfg)
    xq = np.random.default_rng(6).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(xq, jnp.dtype(dtype))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(L.dtype_of(cfg))
    jxp = _layer(jp["dec_blocks"], 0)["xattn"]
    xattn = model.dec_blocks[0].xattn
    jout, (jk, jv) = JED.cross_attention_fwd(jxp, jcfg, jx, jm, None)
    with torch.no_grad():
        out, (k, v) = ED.cross_attention_fwd(xattn, cfg, tx, tm, None)
        out2, _ = ED.cross_attention_fwd(xattn, cfg, tx, None, (k, v))
    jout2, _ = JED.cross_attention_fwd(jxp, jcfg, jx, None, (jk, jv))
    for got, want in ((out, jout), (k, jk), (v, jv), (out2, jout2)):
        _close(got, want, *TOL[dtype])
    np.testing.assert_array_equal(out2.float().numpy(), out.float().numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_block_matches_jax(dtype):
    """Causal self-attention, cross-attention to a memory, the FFN; and the
    same block on a cache (a prefill of 7 then one token)."""
    cfg, jcfg, jp, model = _carried(dtype)
    _, jm, tm = _frames(cfg)
    xq = np.random.default_rng(7).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(xq, jnp.dtype(dtype))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(L.dtype_of(cfg))
    bp = _layer(jp["dec_blocks"], 1)
    want, jcache, _ = JED.decoder_block_fwd(bp, jcfg, jx, _jpositions(2, 8), memory=jm)
    blk = model.dec_blocks[1]
    with torch.no_grad():
        got, cache, none = blk(tx, torch.arange(8).expand(2, 8), tm)
    assert none is None and cache.length == 8
    for g, w in ((got, want), (cache.k, jcache.k), (cache.v, jcache.v)):
        _close(g, w, *TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_forward_and_loss_match_jax(dtype):
    cfg, jcfg, jp, model = _carried(dtype)
    _, jf, tf = _frames(cfg)
    tok = _tokens(cfg, (2, 12))
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -100
    jmem = JED.encode(jp, jcfg, jf)
    jlogits = JED.forward(jp, jcfg, jnp.asarray(tok), jf).logits
    jloss, jmet = JED.lm_loss(jp, jcfg, jnp.asarray(tok), jnp.asarray(labels), jf)
    with torch.no_grad():
        mem = ED.encode(model, tf)
        out = model(_t(tok), tf)
        loss, met = ED.lm_loss(model, _t(tok), _t(labels), tf)
    assert mem.dtype == L.dtype_of(cfg) and out.logits.dtype == torch.float32
    assert out.logits.shape == (2, 12, cfg.padded_vocab) and out.aux_losses == {}
    _close(mem, jmem, *STACK_TOL[dtype])
    _close(out.logits, jlogits, *LOGIT_TOL[dtype])
    rel = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rel)
    assert int(met["tokens"]) == int(jmet["tokens"]) == 22
    assert set(met) == set(jmet) and float(met["total_loss"]) == float(loss)


def test_gradients_match_jax():
    """float32 ``lm_loss`` and every leaf's gradient (remat per block, as
    the smoke config's ``remat="block"``) in the reference's layout."""
    cfg, jcfg, jp, model = _carried()
    _, jf, tf = _frames(cfg)
    tok = _tokens(cfg, (2, 12))
    labels = np.roll(tok, -1, axis=1)
    (jloss, _), jg = jax.value_and_grad(JED.lm_loss, has_aux=True)(
        jp, jcfg, jnp.asarray(tok), jnp.asarray(labels), jf)
    params = dict(model.named_parameters())
    loss, _ = ED.lm_loss(model, _t(tok), _t(labels), tf)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = convert._flatten(convert.lm_tree_to_numpy(dict(zip(params, grads)), cfg))
    want = convert._flatten(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k in want:
        scale = float(np.max(np.abs(want[k]))) or 1.0
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)
    # Rows of dec_pos past the 12 positions get no gradient, in both.
    assert not np.any(got["dec_pos"][12:]) and np.any(got["dec_pos"][:12])


def test_remat_equals_none():
    """The same loss and gradients with one checkpoint a block and with
    none (the recompute runs the same plain operations)."""
    cfg, _, _, model = _carried()
    _, _, tf = _frames(cfg)
    tok = _t(_tokens(cfg, (2, 10)))
    params = list(model.parameters())
    out = []
    for remat in ("block", "none"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss, _ = ED.lm_loss(model, tok, tok, tf)
        out.append((loss, torch.autograd.grad(loss, params)))
    model.cfg = cfg
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- serving


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_cached_decode_match_jax(dtype):
    """The prefill step (the reference's: the cache sized to the prompt
    by default; here one of 16 to decode into), then 4 cached decode steps
    against the reference's (a fresh state each side: the port updates its
    caches in place); every state leaf; in float32 the decode logits equal
    ``forward``'s at the same positions."""
    cfg, jcfg, jp, model = _carried(dtype)
    _, jf, tf = _frames(cfg)
    tok = _tokens(cfg, (2, 12))
    jst = JED.init_decode_state(jp, jcfg, jf, 2, 16)
    jl, jst = JED.decode_step(jp, jcfg, jnp.asarray(tok[:, :8]), jst, jnp.asarray(0, jnp.int32),
                              prefill=True)
    jsteps = []
    for i in range(8, 12):
        lg, jst = JED.decode_step(jp, jcfg, jnp.asarray(tok[:, i:i + 1]), jst,
                                  jnp.asarray(i, jnp.int32))
        jsteps.append(lg)
    l1, st = build_prefill_step(cfg)(model, _t(tok[:, :8]), tf, 16)
    decode = build_decode_step(cfg)
    steps = []
    for i in range(8, 12):
        lg, st = decode(model, _t(tok[:, i:i + 1]), st, i)
        steps.append(lg)
    for got, want in ((l1, jl), *zip(steps, jsteps)):
        _close(got, want, *LOGIT_TOL[dtype])
    assert isinstance(st, ED.EncDecState) and st.self_kv.length == int(jst.self_kv.length) == 12
    assert st.cross_k.shape == (cfg.n_layers, 2, cfg.encdec.encoder_seq, cfg.n_kv_heads,
                                cfg.resolved_head_dim)
    for got, want in ((st.self_kv.k, jst.self_kv.k), (st.self_kv.v, jst.self_kv.v),
                      (st.cross_k, jst.cross_k), (st.cross_v, jst.cross_v)):
        _close(got, want, *STACK_TOL[dtype])
    if dtype == "float32":
        with torch.no_grad():
            full = model(_t(tok), tf).logits
        np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, 8:].numpy(), atol=2e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(l1.numpy(), full[:, :8].numpy(), atol=2e-5, rtol=1e-5)


def test_prefill_sizes_the_cache_to_the_prompt_by_default():
    """As the reference's: a cache of the prompt's length, which the port
    then refuses to write past (the reference clamps the write)."""
    cfg, _, _, model = _carried()
    _, _, tf = _frames(cfg)
    tok = _t(_tokens(cfg, (2, 6)))
    logits, st = build_prefill_step(cfg)(model, tok, tf)
    assert logits.shape == (2, 6, cfg.padded_vocab) and st.self_kv.k.shape[2] == 6
    with pytest.raises(ValueError, match="max_len"):
        build_decode_step(cfg)(model, tok[:, :1], st, 6)


def test_greedy_generate_matches_jax():
    """``ServeEngine.generate(frames=)`` (the prompt through the cached
    decode path, as the reference's) token for token; it needs frames."""
    cfg, jcfg, jp, model = _carried()
    _, jf, tf = _frames(cfg)
    prompts = _tokens(cfg, (2, 8), seed=4)
    want = np.asarray(JServeEngine(jcfg, jp, max_len=32).generate(
        jnp.asarray(prompts), n_tokens=6, frames=jf))
    eng = ServeEngine(cfg, model, max_len=32, device="cpu")
    out = eng.generate(_t(prompts), 6, frames=tf)
    np.testing.assert_array_equal(out.numpy(), want)
    with torch.no_grad():
        full = model(out[:, :-1], tf).logits
    np.testing.assert_array_equal(full[:, 7:].argmax(-1).numpy(), out[:, 8:].numpy())
    with pytest.raises(ValueError, match="frames"):
        eng.generate(_t(prompts), 2)


def test_decoder_positions_past_the_table_raise():
    cfg, _, _, model = _carried()
    _, _, tf = _frames(cfg, b=1)
    st = ED.init_decode_state(model, tf, 1, 4)
    with pytest.raises(ValueError, match="MAX_DEC_POS"):
        ED.decode_step(model, torch.zeros((1, 1), dtype=torch.int64), st, ED.MAX_DEC_POS)


# ---------------------------------------------------------------- training


def test_training_frames_are_the_references_bits():
    """``audio_frames`` against the reference loop's ``jnp.asarray(rng.normal
    (...), bfloat16)`` bit for bit, at whisper's (1, 1500, 1280) (the
    float64 draws' double rounding through float32 changes ~1 element in
    1.3e5 against a direct rounding: some must occur here) and at the smoke
    config's float32."""
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="bfloat16",
                              encdec=dataclasses.replace(smoke_config(ARCH).encdec,
                                                         encoder_seq=1500), d_model=1280)
    got = audio_frames(cfg, 1, 7, "cpu")
    x = np.random.default_rng(7).normal(scale=0.02, size=(1, 1500, 1280))
    want = np.asarray(jnp.asarray(x, jnp.bfloat16).view(jnp.uint16))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 1500, 1280)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    f32 = x.astype(np.float32)
    assert ((f32.view(np.uint32) & 0xFFFF) == 0x8000).sum() > 0  # ties met, rounded as JAX
    small = audio_frames(smoke_config(ARCH), 2, 3, "cpu")
    x = np.random.default_rng(3).normal(scale=0.02, size=(2, 64, 128))
    np.testing.assert_array_equal(small.numpy(), np.asarray(jnp.asarray(x, jnp.float32)))


def test_reference_ndim_decays_the_stacked_norms():
    """The reference's tree stacks the per-layer layernorm scales and
    biases to rank 2, so AdamW decays them; ``ln_enc``/``ln_f`` (rank 1)
    are not decayed; ``dec_pos`` (rank 2) is."""
    cfg, _, _, model = _carried()
    shapes = convert.lm_tree_shapes(cfg)
    for name, p in model.named_parameters():
        path = name
        head, _, rest = name.partition(".")
        if head in ("enc_blocks", "dec_blocks"):
            path = f"{head}.{rest.partition('.')[2]}"
        assert adamw.reference_ndim(name, p) == len(shapes[path][0]), name
    nd = lambda n: adamw.reference_ndim(n, dict(model.named_parameters())[n])
    assert nd("enc_blocks.0.ln1.scale") == nd("dec_blocks.1.ln_x.bias") == nd("dec_pos") == 2
    assert nd("ln_enc.scale") == nd("ln_f.bias") == 1


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    """Two ``build_train_step`` steps (AdamW with weight decay, the schedule
    warmed up in one step, the frames in the batch) against the JAX
    package's jitted step: the loss, the grad norm, the learning rate and
    every parameter within 1e-5 of its leaf's scale plus 1e-7 (an element
    within 2 lr a step where a gradient near float32 noise may flip its
    normalised update)."""
    cfg, jcfg, jp, model = _carried()
    opt = dict(lr=1e-3, weight_decay=0.1)
    kw = dict(microbatches=microbatches, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jbuild_train_step(jcfg, JAdamWConfig(**opt), **kw))
    tstep = build_train_step(cfg, AdamWConfig(**opt), **kw)
    js = jadamw_init(jp, JAdamWConfig(**opt))
    ts = adamw_init(dict(model.named_parameters()), AdamWConfig(**opt))
    ds = SyntheticLMDataset(DataConfig(batch=4, seq_len=10, vocab_size=cfg.vocab_size))
    for step in range(2):
        batch = ds.batch_at(step)
        batch["frames"] = audio_frames(cfg, 4, step, "cpu").numpy()
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(step))
        model, ts, tm = tstep(model, ts, batch, step)
        for key in ("loss", "lm_loss", "grad_norm", "lr", "total_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-9,
                                       err_msg=f"step {step} {key}")
    g, w = convert._flatten(convert.lm_params_to_numpy(model)), convert._flatten(
        jax.tree.map(np.asarray, jp))
    assert g.keys() == w.keys()
    for k in w:
        err = np.abs(g[k] - w[k])
        tight = err <= 1e-5 * float(np.max(np.abs(w[k]))) + 1e-7
        assert (~tight).sum() <= max(1, int(1e-3 * tight.size)), (k, tight.mean(), err.max())
        assert err.max() <= 2 * opt["lr"] * 2, (k, err.max())


def test_train_loop_and_launcher_run_whisper_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve, train as launch_train
    from repro_torch.train import TrainConfig, train

    cfg = smoke_config(ARCH)
    res = train(cfg, DataConfig(batch=2, seq_len=8, vocab_size=cfg.vocab_size),
                AdamWConfig(lr=1e-3), TrainConfig(steps=2, log_every=1), device="cpu")
    assert isinstance(res["params"], ED.EncDec) and len(res["history"]) == 2
    assert all(math.isfinite(r["loss"]) for r in res["history"])
    launch_train.main(["--arch", "whisper-large-v3", "--steps", "2", "--batch", "2", "--seq",
                       "8", "--device", "cpu"])
    launch_serve.main(["--arch", "whisper-large-v3", "--requests", "2", "--prompt-len", "4",
                       "--gen-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'step': 1" in out and "req1: [" in out


# ------------------------------------------------------------------ the tree


def test_tree_matches_jax_and_round_trips():
    """Paths, shapes and types leaf for leaf against ``jax.eval_shape`` of
    ``repro.models.encdec.init`` in float32 and bf16; ``dec_pos`` drawn at
    0.02; ``lm_params_from_numpy`` then ``lm_params_to_numpy`` gives the
    tree back bit for bit; the port's own ``init`` draws every leaf."""
    for dtype in DTYPES:
        cfg, jcfg = _cfgs(dtype)
        want = {".".join(k.key for k in p): (tuple(l.shape), np.dtype(l.dtype)) for p, l in
                jax.tree_util.tree_flatten_with_path(
                    jax.eval_shape(lambda: JED.init(jax.random.key(0), jcfg)))[0]}
        got = {p: (s, np.dtype(str(d).removeprefix("torch.")))
               for p, (s, d) in convert.lm_tree_shapes(cfg).items()}
        assert got == want
    assert want["dec_pos"] == ((JED.MAX_DEC_POS, cfg.d_model), np.dtype("bfloat16"))
    cfg, _ = _cfgs()
    tree = convert.random_lm_tree(cfg, 2)
    assert 0.015 < tree["dec_pos"].std() < 0.02 and np.abs(tree["dec_pos"]).max() <= 0.04
    np.testing.assert_array_equal(tree["enc_blocks"]["ln1"]["bias"], 0.0)
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    back = convert._flatten(convert.lm_params_to_numpy(model))
    flat = convert._flatten(tree)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    np.testing.assert_array_equal(model.dec_blocks[1].xattn.wk.kernel.detach().numpy(),
                                  tree["dec_blocks"]["xattn"]["wk"]["kernel"][1])
    own = ED.init(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert 0.015 < float(own.dec_pos.std()) < 0.02
    assert float(own.ln_enc.scale.min()) == 1.0 and float(own.ln_f.bias.abs().max()) == 0.0
    with pytest.raises(ValueError, match="encdec"):
        T.Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        T.init_decode_state(cfg, 1, 4, device="cpu")
