"""How far one process's bf16 training steps lie from its float32 ones:
the controls behind ``chip_smoke.py`` phase 26d's float32 zamba2 run.

Run from the root of a checkout on a card (``python3
tools/tp_train_control.py``; it needs CUDA).  For each family of phase 26d
(zamba2-2.7b, rwkv6-7b and whisper-large-v3 at full width, cut in depth as
``chip_smoke.TPF`` says, in bf16) it runs ``TPF["steps"]`` steps of one
process from the family's seeded weights three ways, on the kernels,
on the plain versions (``ops.forced("ref")``) and in float32 on the same
bf16 weights, and prints each step's loss and grad norm (lines ``CTL``).
Then, for zamba2 in bf16, two gloo ranks sharing the card on (1, 2) take the first
step's gradients (``train.step.loss_fn``, summed by ``reduce_grads``) and
hold each leaf to one process's bf16 gradients, beside one process's bf16
gradients held to its float32 ones: the largest difference over the leaf's
largest |gradient| and the share of elements whose sign differs, by leaf
name past the layer indices (lines ``DIAG``).
"""
import dataclasses
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402


def _bf16_cfg(fam: str):
    """Phase 26d's config of ``fam`` in bf16 (the full configs' type)."""
    return dataclasses.replace(cs._tpf_cfg(fam, train=True), dtype="bfloat16")


def _short(name: str) -> str:
    return re.sub(r"\.\d+", "", name)


def _stats(got, want) -> tuple:
    a, b = got.double(), want.double()
    scale = float(b.abs().max()) or 1.0
    flips = float(((a.sign() != b.sign()) & (b != 0)).double().mean())
    return float((a - b).abs().max()) / scale, flips, b.numel()


def _by_name(rows: dict) -> dict:
    out = {}
    for n, (r, f, k) in rows.items():
        s = out.setdefault(_short(n), [0.0, 0.0, 0])
        s[0], s[1], s[2] = max(s[0], r), s[1] + f * k, s[2] + k
    return {n: (round(v[0], 4), round(v[1] / max(v[2], 1), 5)) for n, v in out.items()}


def _f32_copy(cfg, model, dev):
    import torch

    from repro_torch.models import encdec as ED, transformer as T

    c = dataclasses.replace(cfg, dtype="float32")
    m32 = (ED.EncDec if cfg.family == "audio" else T.Transformer)(c, device=dev)
    with torch.no_grad():
        for (_, p), (_, q) in zip(m32.named_parameters(), model.named_parameters()):
            p.copy_(q.float())
    return c, m32


def _grads(model, batch) -> dict:
    import torch

    from repro_torch.train.step import loss_fn

    ps = dict(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    gs = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g.detach()) for (n, p), g in zip(ps.items(), gs)}


def _rank(rank, world, store, backend, job, out_dir):
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.sharding import fsdp, rules

    init_world(rank, world, f"file://{store}", device_type="cuda", backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build(["flash_attention", "flash_attention_bwd", "rmsnorm", "rwkv6_scan"])
    cfg = _bf16_cfg("hybrid")
    batch = {k: v.to(dev) for k, v in cs._tpf_batch(cfg, 0, dev).items()}
    one_model = cs._tpf_model("hybrid", cfg, dev)
    one = _grads(one_model, batch)
    _, m32 = _f32_copy(cfg, one_model, dev)
    g32 = _grads(m32, batch)
    control = {n: _stats(one[n], g32[n]) for n in one if one[n].numel()}
    del one_model, m32, g32
    torch.cuda.empty_cache()
    mesh = make_host_mesh(2, device_type="cuda")
    model = fsdp.shard_model(cs._tpf_model("hybrid", cfg, dev), mesh)
    params = dict(model.named_parameters())
    got = fsdp.reduce_grads(_grads(model, rules.shard_batch(batch, mesh)), params, {})
    ranks = {}
    for n, p in params.items():
        w = cs._tpf_chunk(one[n], fsdp.shard_of(p))
        if w.numel():
            ranks[n] = _stats(got[n], w)
    if rank == 0:
        a, c = _by_name(ranks), _by_name(control)
        for n in sorted(a, key=lambda k: -a[k][0]):
            print(f"DIAG {cfg.name} step-0 gradient {n}: ranks vs one process (max|d| / max, sign "
                  f"flips) {a[n]}; one process bf16 vs float32 {c.get(n)}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_train_control: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    _build.build(["flash_attention", "flash_attention_bwd", "rmsnorm", "rwkv6_scan"])
    print(cs._card())
    for fam in ("hybrid", "rwkv", "whisper"):
        cfg = _bf16_cfg(fam)
        runs = {}
        for how in ("kernels", "plain", "float32"):
            model, c = cs._tpf_model(fam, cfg, dev), cfg
            if how == "float32":
                c, model = _f32_copy(cfg, model, dev)
            params = dict(model.named_parameters())
            opt, step = cs._fsdp_step(c)
            state = adamw_init(params, opt)
            runs[how] = []
            with ops.forced("ref" if how == "plain" else None):
                for i in range(cs.TPF["steps"]):
                    batch = {k: v.to(dev) for k, v in cs._tpf_batch(c, i, dev).items()}
                    _, state, met = step(model, state, batch, i)
                    runs[how].append((float(met["loss"]), float(met["grad_norm"])))
            del model, params, state
            torch.cuda.empty_cache()
        print(f"CTL {cfg.name} ({cfg.n_layers} layers), (loss, grad norm) a step: "
              f"{runs}", flush=True)
    try:
        cs._run_world(2, "gloo", "control", target=_rank, join_s=600.0)
    except FileNotFoundError:
        pass  # the ranks print; they write no results
    print(f"tp_train_control: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
