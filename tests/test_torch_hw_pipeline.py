"""The staged hardware-path kernels' schedule, emulated on the CPU.

``csrc/hw_stages.cuh`` runs ``pdu_health`` and ``pdu_sim`` as a pipeline:
a block of 32 racks whose warps are stages (producer, render, ESS ramp,
SoC, LC, wear), handing values on through two shared-memory rings of
``chunk``-sample slots guarded by mbarrier full/empty pairs.  The CUDA
source runs only on the card, so this file emulates that schedule in
float32 on the CPU and holds it, bit for bit, against the plain versions
(``ref.pdu_health_sim``, ``ref.pdu_sim``):

* every stage is a generator that runs one chunk at a time between the
  barrier waits the kernel makes, in the kernel's operation order (the
  fused multiply-adds through ``ref.fma``); a seeded scheduler interleaves
  the stages and lands the producer's copies at random later points, so a
  stage that read a slot before its copy landed, or a producer that
  overwrote a slot still being read, would change the bits; a schedule
  with no stage able to run fails as a deadlock;
* the copies follow the plan's load route: TMA boxes zero-fill the rows
  past T and the racks past R, the cp.async route leaves them as they were
  (NaN here, as uninitialised shared memory); the ragged last chunk and the
  ragged last rack group run on those lanes and rows without storing them;
* the outputs leave through the hand-off slots: on the TMA route a box
  store lands at a random later point and reads the slot then, and the
  warp that issued it waits until at most one of its stores is in flight
  before it writes a slot again (``cp.async.bulk.wait_group.read 1``); on
  the cp.async route the warp stores the chunk itself;
* the render stage walks the episode tables with the kernel's cursor
  (``hw::EventCursor``) and may run up to the ring's depth ahead; a batch
  of samples in which no lane reaches a boundary takes the steady weights
  without walking, as the kernel's render warp does.

``lc_filter`` runs the header's LC-only kernel (``hw::lc_kernel``: producer,
LC and store warps over an input and an output ring), emulated the same way
on each of its four (load, store) routes and held bit for bit against
``ref.lc_filter``.

Also: the launch plans (``kernels/hw_plan.py``): ring depth, shared memory
within the H100's 232,448 bytes for every instantiation, the load route by
R % 4, the LC plan's constants against the header's; the lane map by which
the cp.async route's copies and stores cover a chunk; and ``_build``'s
library name following the headers a source includes.
"""
import random
import re

import numpy as np
import pytest
import torch

from repro_torch.core import health as hlt, pdu
from repro_torch.kernels import _build, hw_plan, ref

torch.set_num_threads(1)
F32 = torch.float32
HZ = 100.0
INT_MAX = 2**31 - 1
S = hw_plan.CHUNK
KBATCH = 8  # csrc/hw_stages.cuh's kBatch


# --------------------------------------------------------------- inputs


def _inputs(t, r, seed):
    """An interval of rack power that steps between load levels, states near
    the SoC window's top for a third of the racks (the clamp and back-off
    run), slew rows, a dense corrective, wear state and the filter."""
    rng = np.random.default_rng(seed)
    steps = rng.choice([0.15, 0.6, 0.95], size=(t // 20 + 2, r))
    rack = np.clip(np.repeat(steps, 20, axis=0)[:t] + 0.01 * rng.standard_normal((t, r)),
                   0.0, 1.0).astype(np.float32)
    cfg = pdu.make_pdu(sample_dt=1.0 / HZ, track_health=True, device="cpu")
    st = pdu.init_state(cfg, torch.from_numpy(rack[0]))
    soc0 = rng.uniform(0.2, 0.8, r).astype(np.float32)
    soc0[: max(r // 3, 1)] = np.float32(0.89995)
    g0 = (rack[0] + 0.05 * rng.standard_normal(r)).astype(np.float32)
    filt = st.filter_obj
    lc = tuple(m.numpy() for m in (filt.ad, filt.bd, filt.c[0]))
    args = (torch.from_numpy(rack), torch.from_numpy(g0), torch.from_numpy(soc0),
            st.filter_state.clone(), *lc)
    slew = (torch.from_numpy(rng.uniform(-5e-3, 5e-3, r).astype(np.float32)),
            torch.from_numpy(rng.uniform(-5e-3, 5e-3, r).astype(np.float32)))
    dense = torch.from_numpy((1e-3 * rng.standard_normal((t, r))).astype(np.float32))
    hs = hlt.init_state(torch.from_numpy(soc0))
    health = (hlt.step_consts(cfg.health), tuple(hs))
    return args, pdu.hw_kwargs(cfg), slew, dense, health


def _events(t, r, rng):
    """Sorted, non-overlapping (E, R) episode tables over a window around
    the interval (some racks dark at its start, some episodes inside it,
    the unused slots clamped past its end), a base row and the window."""
    e = 4
    i0 = 500
    st = np.empty((e, r), np.int64)
    en = np.empty((e, r), np.int64)
    for k in range(r):
        cuts = np.sort(rng.choice(np.arange(i0 - 40, i0 + t + 40), size=2 * e, replace=False))
        st[:, k], en[:, k] = cuts[0::2], cuts[1::2] + 1
    st[-1, ::2] = en[-1, ::2] = i0 + t + 100  # an empty trailing slot
    base = rng.uniform(0.3, 1.0, r).astype(np.float32)
    base[0] = 0.0
    return (torch.from_numpy(st.astype(np.int32)), torch.from_numpy(en.astype(np.int32)),
            torch.from_numpy(base), i0, i0 + t - 1)


# ----------------------------------------------------------- the barrier


class Bar:
    """An mbarrier: arrivals and a transaction count complete its phase;
    ``passed(parity)`` is ``mbarrier.try_wait.parity``."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, n=1, tx=0):
        self.pending -= n
        self.tx += tx
        assert self.pending >= 0, "more arrivals than the barrier expects"
        self._complete()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        assert self.tx >= 0
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


# ------------------------------------------------------ the stage physics


def _where(c, a, b):
    return torch.where(c, torch.as_tensor(a, dtype=F32), torch.as_tensor(b, dtype=F32))


def _clamp_nan(x, lo, hi):
    return _where(x < lo, lo, _where(x > hi, hi, x))


def _relu_nan(x):
    return _where(x < 0.0, 0.0, x)


def _ess_ramp(k, masked, r_t, c_t, w_t, g):
    """``hw::ess_ramp``: returns (g', p, x)."""
    g_new = ref.fma(k.alpha, r_t - g, g)
    if masked:
        g_new = _where(w_t > 0.0, g_new, r_t)
    p = _clamp_nan(g_new - r_t + c_t, -k.p_max, k.p_max)
    if masked:
        p = p * w_t
    charge = _relu_nan(p)
    discharge = _relu_nan(-p)
    return g_new, p, ref.fma(k.eta_c, charge, -(discharge * k.inv_eta_d))


def _ess_soc(k, masked, r_t, w_t, p, x, soc):
    """``hw::ess_soc``: returns (soc', node)."""
    soc_new = ref.fma(k.k_soc, x, soc)
    over_hi = _relu_nan(soc_new - k.soc_max)
    over_lo = _relu_nan(k.soc_min - soc_new)
    p = ref.fma(over_lo, k.bo_lo, ref.fma(-over_hi, k.bo_hi, p))
    soc_new = _clamp_nan(soc_new, k.soc_min, k.soc_max)
    if masked:
        soc_new = _where(w_t > 0.0, soc_new, soc)
    return soc_new, r_t + p


def _lc_step(lc, node, x):
    """``hw::lc_step``: returns (y, x')."""
    a, bl, bv, c = lc
    x0, x1, x2 = x
    y = ref.fma(c[2], x2, ref.fma(c[0], x0, c[1] * x1))
    nxt = tuple(ref.fma(bl[i], node, ref.fma(a[3 * i + 2], x2, ref.fma(a[3 * i], x0,
                                                                       a[3 * i + 1] * x1)))
                + bv[i] for i in range(3))
    return y, nxt


def _wear_step(hc, w, soc_new):
    """``hw::Wear::step``."""
    c0, c1, eps, kappa = hc
    prev, last_ext, dirn, half, dmg, mdod = w
    delta = soc_new - prev
    sd = _where(delta > eps, 1.0, _where(delta < -eps, -1.0, 0.0))
    rev = sd * dirn < 0.0
    revf = rev.to(F32)
    depth = torch.abs(prev - last_ext)
    half_w = _relu_nan(ref.fma(c1, prev + last_ext, c0))
    if kappa == 1.0 or (kappa.is_integer() and 2 <= kappa <= 4):
        pw = depth
        for _ in range(int(kappa) - 1):
            pw = pw * depth
    else:
        pw = torch.pow(depth, kappa)
    dmg = dmg + revf * (half_w * pw)
    m = revf * depth
    mdod = _where((m > mdod) | (m != m), m, mdod)
    last_ext = _where(rev, prev, last_ext)
    dirn = _where(sd != 0.0, sd, dirn)
    return soc_new, last_ext, dirn, half + revf, dmg, mdod


class Cursor:
    """``hw::EventCursor`` on every lane at once (dead lanes never walk)."""

    def __init__(self, ev, live, rpad):
        st, en, base, i0, t_last = ev
        r = st.shape[1]
        pad = lambda a, v: torch.cat([a, torch.full(a.shape[:-1] + (rpad - r,), v, dtype=a.dtype)],
                                     dim=-1)
        self.st, self.en = pad(st.to(torch.int64), 0), pad(en.to(torch.int64), 0)
        self.base = pad(base.to(F32), 0.0)
        self.i0, self.t_last, self.e = int(i0), int(t_last), st.shape[0]
        self.live = live
        self.cs = torch.zeros(rpad, dtype=torch.int64)
        self.ce = torch.zeros(rpad, dtype=torch.int64)
        self.sel_s, self.next_s = self.st[0].clone(), self.st[0].clone()
        self.sel_e, self.next_e = self.en[0].clone(), self.en[0].clone()
        self.lanes = torch.arange(rpad)

    def _row(self, tab, cnt):
        return torch.where(cnt < self.e, tab[cnt.clamp(max=self.e - 1), self.lanes],
                           torch.full_like(cnt, INT_MAX))

    def quiet(self, hi, edge):
        """``hw::EventCursor::quiet`` on every lane."""
        return (self.next_s > hi) & ((edge > 1) | (self.next_e > hi))

    def weight(self, t, edge, inv):
        idx = min(self.i0 + t, self.t_last)
        while True:
            m = self.live & (self.cs < self.e) & (self.next_s <= idx)
            if not bool(m.any()):
                break
            self.sel_s = torch.where(m, self.next_s, self.sel_s)
            self.sel_e = torch.where(m, self.en[self.cs.clamp(max=self.e - 1), self.lanes],
                                     self.sel_e)
            self.cs = self.cs + m.to(torch.int64)
            self.next_s = torch.where(m, self._row(self.st, self.cs), self.next_s)
        if edge <= 1:
            while True:
                m = self.live & (self.ce < self.e) & (self.next_e <= idx)
                if not bool(m.any()):
                    break
                self.ce = self.ce + m.to(torch.int64)
                self.next_e = torch.where(m, self._row(self.en, self.ce), self.next_e)
        return self.steady(t, edge, inv)

    def steady(self, t, edge, inv):
        idx = min(self.i0 + t, self.t_last)
        if edge <= 1:
            intensity = _where(self.cs - self.ce > 0, 1.0, 0.0)
        else:
            wa = (idx - self.sel_s).to(F32)
            wz = (idx - self.sel_e).to(F32)
            ramp = (torch.clamp((wa + 1.0) * inv, 0.0, 1.0)
                    - torch.clamp((wz + 1.0) * inv, 0.0, 1.0))
            intensity = _where(self.cs > 0, ramp, 0.0)
        return (1.0 - intensity) * self.base


# ---------------------------------------------------------- the schedule


def emulate(rack, g0, soc0, x0, ad, bd, c_row, *, k, plan, slew=None, corrective=None,
            health=None, ess_on=None, ess_events=None, ess_edge=1, seed=0):
    """Run ``csrc/hw_stages.cuh``'s pipeline on the CPU under ``plan``.
    ``k``: the step constants (``ref.hw_consts`` for ``pdu_health``,
    ``ref.pdu_sim_consts`` for ``pdu_sim``).  Returns ``(grid, soc_t,
    (g_f, soc_f, x_f), wear_carries_or_None)``."""
    t_len, r = rack.shape
    rpad = -(-r // hw_plan.RACKS) * hw_plan.RACKS
    live = torch.arange(rpad) < r
    chunk, nslot = plan.chunk, plan.slots
    tma = plan.route == "tma"
    nchunk = -(-t_len // chunk)
    mask = (hw_plan.MASK_NONE if ess_on is None and ess_events is None else
            hw_plan.MASK_EVENTS if ess_events is not None else
            hw_plan.MASK_ROW if ess_on.ndim == 1 else hw_plan.MASK_SERIES)
    render = slew is not None or mask == hw_plan.MASK_EVENTS
    loads = [rack.to(F32)] + ([corrective.to(F32)] if slew is None else []) + (
        [ess_on.to(F32)] if mask == hw_plan.MASK_SERIES else [])
    a, bl, bv, c = ref.lc_consts(ad, bd, c_row)
    lc = (a, bl, bv, c)
    padv = lambda v, fill=0.0: torch.cat([v.to(F32), torch.full((rpad - r,), fill, dtype=F32)])

    # Shared memory: never-written slots read as NaN.
    ring = torch.full((nslot, plan.n_in, chunk, rpad), float("nan"), dtype=F32)
    hand = torch.full((nslot, hw_plan.N_HAND, chunk, rpad), float("nan"), dtype=F32)
    in_full = [Bar((1 if tma else 32) + (32 if render else 0)) for _ in range(nslot)]
    in_empty = [Bar(64) for _ in range(nslot)]  # ramp, SoC
    ramp_full = [Bar(32) for _ in range(nslot)]
    kp = 2 + (mask in (hw_plan.MASK_SERIES, hw_plan.MASK_EVENTS))  # the ramp's p, then x
    hand_full = [Bar(32) for _ in range(nslot)]
    hand_empty = [Bar(32 * (1 + (health is not None))) for _ in range(nslot)]
    grid = torch.full((t_len, r), float("nan"), dtype=F32)
    soc_t = torch.full((t_len, r), float("nan"), dtype=F32)
    out = {}
    pending = []  # copies and stores issued, not yet landed
    stores = {"ess": [], "lc": []}  # each warp's stores, in issue order
    done = set()  # stores that have landed
    # the producer copies rack, [corrective], [weight] into arrays 0, 1, 2
    slots_of = [0] + ([1] if slew is None else []) + ([2] if mask == hw_plan.MASK_SERIES else [])

    def land(s, t0):
        n = min(chunk, t_len - t0)
        for arr, src in zip(slots_of, loads):
            if tma:
                ring[s, arr] = 0.0  # the box's rows past T and racks past R
            ring[s, arr, :n, :r] = src[t0:t0 + n]
        if tma:
            in_full[s].complete_tx(len(loads) * chunk * hw_plan.RACKS * 4)
        else:
            in_full[s].arrive(32)

    def store(owner, s, arr, dst, t0):
        n = min(chunk, t_len - t0)

        def land():
            dst[t0:t0 + n] = hand[s, arr, :n, :r]
            done.add(land)

        stores[owner].append(land)
        if tma:
            pending.append(land)
        else:
            land()

    def slot_free(owner):
        # wait_group.read 1: every group but the most recent has read its slot
        return lambda: all(f in done for f in stores[owner][:-1])

    def producer():
        for ci in range(nchunk):
            s = ci % nslot
            if ci >= nslot:
                yield in_empty[s], ((ci // nslot) - 1) & 1
            if tma:
                in_full[s].arrive(1, tx=len(loads) * chunk * hw_plan.RACKS * 4)
            pending.append(lambda s=s, t0=ci * chunk: land(s, t0))

    def render_stage():
        applied = diff = None
        if slew is not None:
            applied = padv(slew[0].to(F32).expand(r))
            diff = padv(slew[1].to(F32).expand(r) - slew[0].to(F32).expand(r))
        cur = Cursor(ess_events, live, rpad) if mask == hw_plan.MASK_EVENTS else None
        inv = float(np.float32(1.0 / ess_edge)) if ess_edge > 1 else 1.0
        inv_t = np.float32(1.0) / np.float32(t_len)
        for ci in range(nchunk):
            s, t0 = ci % nslot, ci * chunk
            if ci >= nslot:
                yield in_empty[s], ((ci // nslot) - 1) & 1
            n = min(chunk, t_len - t0)
            for j in range(n):
                t = t0 + j
                if slew is not None:
                    ring[s, 1, j] = ref.fma(diff, float(np.float32(t + 1) * inv_t), applied)
            # hw::render_batch: whole batches of kBatch, then single samples
            starts = list(range(0, n - n % KBATCH, KBATCH)) + list(range(n - n % KBATCH, n))
            for j0 in starts if cur is not None else ():
                nb = KBATCH if j0 + KBATCH <= n - n % KBATCH else 1
                hi = min(cur.i0 + t0 + j0 + nb - 1, cur.t_last)
                quiet = bool((~live | cur.quiet(hi, ess_edge)).all())
                for b in range(nb):
                    t = t0 + j0 + b
                    ring[s, 2, j0 + b] = (cur.steady(t, ess_edge, inv) if quiet else
                                          _where(live, cur.weight(t, ess_edge, inv), 1.0))
            in_full[s].arrive(32)

    def weight(s, j, w_row):
        return (w_row if mask == hw_plan.MASK_ROW else
                ring[s, 2, j] if mask != hw_plan.MASK_NONE else None)

    def ramp():
        g = padv(g0.expand(r))
        w_row = padv(ess_on, 1.0) if mask == hw_plan.MASK_ROW else None
        for ci in range(nchunk):
            s, t0 = ci % nslot, ci * chunk
            yield in_full[s], (ci // nslot) & 1
            for j in range(min(chunk, t_len - t0)):
                g, ring[s, kp, j], ring[s, kp + 1, j] = _ess_ramp(
                    k, mask != hw_plan.MASK_NONE, ring[s, 0, j], ring[s, 1, j],
                    weight(s, j, w_row), g)
            ramp_full[s].arrive(32)
            in_empty[s].arrive(32)
        out["g"] = g[:r]

    def soc_stage():
        soc = padv(soc0.expand(r))
        w_row = padv(ess_on, 1.0) if mask == hw_plan.MASK_ROW else None
        for ci in range(nchunk):
            s, t0 = ci % nslot, ci * chunk
            ph = (ci // nslot) & 1
            yield in_full[s], ph
            yield ramp_full[s], ph
            if ci >= nslot:
                yield hand_empty[s], ph ^ 1
            yield slot_free("ess")
            for j in range(min(chunk, t_len - t0)):
                soc, hand[s, 0, j] = _ess_soc(k, mask != hw_plan.MASK_NONE, ring[s, 0, j],
                                              weight(s, j, w_row), ring[s, kp, j].clone(),
                                              ring[s, kp + 1, j], soc)
                hand[s, 1, j] = soc
            in_empty[s].arrive(32)
            store("ess", s, 1, soc_t, t0)
            hand_full[s].arrive(32)
        out["soc"] = soc[:r]

    def lc_stage():
        x = tuple(padv(x0[:, i]) for i in range(3))
        for ci in range(nchunk):
            s, t0 = ci % nslot, ci * chunk
            yield hand_full[s], (ci // nslot) & 1
            yield slot_free("lc")
            for j in range(min(chunk, t_len - t0)):
                y, x = _lc_step(lc, hand[s, 0, j], x)
                hand[s, 2, j] = y
            hand_empty[s].arrive(32)
            store("lc", s, 2, grid, t0)
        out["x"] = torch.stack([v[:r] for v in x], dim=1)

    def wear_stage():
        hc = ref.health_step_consts(health[0])
        w = tuple(padv(leaf.to(F32).expand(r)) for leaf in health[1][:6])
        for ci in range(nchunk):
            s, t0 = ci % nslot, ci * chunk
            yield hand_full[s], (ci // nslot) & 1
            for j in range(min(chunk, t_len - t0)):
                w = _wear_step(hc, w, hand[s, 1, j].clone())  # a register, not the slot
            hand_empty[s].arrive(32)
        out["wear"] = tuple(v[:r] for v in w)

    stages = {"producer": producer(), "ramp": ramp(), "soc": soc_stage(), "lc": lc_stage()}
    if render:
        stages["render"] = render_stage()
    if health is not None:
        stages["wear"] = wear_stage()
    _schedule(stages, pending, seed)
    return grid, soc_t, (out["g"], out["soc"], out["x"]), out.get("wear")


def _schedule(stages, pending, seed):
    """Run the stage generators to their ends under a seeded scheduler.  A
    stage yields what it waits for: ``(barrier, parity)`` or a predicate;
    ``pending`` holds the issued copies and stores, each landing when the
    scheduler picks it."""
    waits = {name: None for name in stages}
    rng = random.Random(seed)
    while stages or pending:
        ready = [n for n in stages if waits[n] is None or (
            waits[n]() if callable(waits[n]) else waits[n][0].passed(waits[n][1]))]
        assert ready or pending, f"deadlock: every stage waits ({sorted(stages)})"
        # Copies and stores land late more often than not, so that a stage
        # that does not wait for one reads or overwrites its slot too soon.
        if pending and (not ready or rng.random() < 0.1):
            pending.pop(rng.randrange(len(pending)))()
            continue
        pick = rng.choice(ready)
        try:
            waits[pick] = next(stages[pick])
        except StopIteration:
            del stages[pick], waits[pick]


def emulate_lc(x0, node, ad, bd, c_row, *, plan, seed=0):
    """Run ``csrc/hw_stages.cuh``'s LC-only kernel (``hw::lc_kernel``) on the
    CPU under ``plan`` (``hw_plan.lc_plan``): the producer copies each chunk
    of node power into an input slot (TMA boxes zero-filling past T and R, or
    ``cp.async`` leaving those rows and racks as they were), the LC stage
    steps the state from the input slot into an output slot, the store stage
    stores each output slot whole (a box store landing at a random later
    point, or the spread stores at once) and frees it: a spread-stored slot
    at once, a box-stored one's predecessor once at most one of its stores
    still reads (``cp.async.bulk.wait_group.read 1``).  Returns ``(grid,
    x_final)``."""
    t_len, r = node.shape
    rpad = -(-r // hw_plan.RACKS) * hw_plan.RACKS
    chunk, nslot = plan.chunk, plan.slots
    tma_load, tma_store = plan.loads == "tma", plan.stores == "tma"
    nchunk = -(-t_len // chunk)
    lc = ref.lc_consts(ad, bd, c_row)
    box = chunk * hw_plan.RACKS * 4
    ins = torch.full((nslot, chunk, rpad), float("nan"), dtype=F32)
    outs = torch.full((nslot, chunk, rpad), float("nan"), dtype=F32)
    in_full = [Bar(1 if tma_load else 32) for _ in range(nslot)]
    in_empty, out_full, out_empty = ([Bar(32) for _ in range(nslot)] for _ in range(3))
    grid = torch.full((t_len, r), float("nan"), dtype=F32)
    out, pending, issued, done = {}, [], [], set()

    def land(s, t0):
        n = min(chunk, t_len - t0)
        if tma_load:
            ins[s] = 0.0
        ins[s, :n, :r] = node[t0:t0 + n].to(F32)
        if tma_load:
            in_full[s].complete_tx(box)
        else:
            in_full[s].arrive(32)

    def producer():
        for ci in range(nchunk):
            s = ci % nslot
            if ci >= nslot:
                yield in_empty[s], ((ci // nslot) - 1) & 1
            if tma_load:
                in_full[s].arrive(1, tx=box)
            pending.append(lambda s=s, t0=ci * chunk: land(s, t0))

    def lc_stage():
        x = tuple(torch.cat([x0[:, i].to(F32), torch.zeros(rpad - r, dtype=F32)])
                  for i in range(3))
        for ci in range(nchunk):
            s, ph = ci % nslot, (ci // nslot) & 1
            yield in_full[s], ph
            if ci >= nslot:
                yield out_empty[s], ph ^ 1
            for j in range(min(chunk, t_len - ci * chunk)):
                outs[s, j], x = _lc_step(lc, ins[s, j].clone(), x)
            in_empty[s].arrive(32)
            out_full[s].arrive(32)
        out["x"] = torch.stack([v[:r] for v in x], dim=1)

    def box_store(s, t0):
        n = min(chunk, t_len - t0)

        def store():
            grid[t0:t0 + n] = outs[s, :n, :r]
            done.add(store)

        return store

    def store_stage():
        for ci in range(nchunk):
            s = ci % nslot
            yield out_full[s], (ci // nslot) & 1
            store = box_store(s, ci * chunk)
            issued.append(store)
            if not tma_store:
                store()
                out_empty[s].arrive(32)
                continue
            pending.append(store)
            yield lambda: all(f in done for f in issued[:-1])
            if ci > 0:
                out_empty[(ci - 1) % nslot].arrive(32)

    _schedule({"producer": producer(), "lc": lc_stage(), "store": store_stage()}, pending, seed)
    return grid, out["x"]


# ------------------------------------------------------------- pdu_health

R_SHAPES = (1, 3, 33, 1000)
T_SHAPES = (1, 7, S - 1, S + 1)
MODES = ("none", "row", "series", "events1", "events50")


def _mode_kw(mode, t, r, rng):
    if mode == "row":
        return dict(ess_on=torch.from_numpy((rng.uniform(0, 1, r) > 0.4).astype(np.float32)))
    if mode == "series":
        w = np.clip(np.linspace(1.2, -0.3, t)[:, None] + rng.uniform(-0.2, 0.2, (1, r)), 0, 1)
        return dict(ess_on=torch.from_numpy(w.astype(np.float32)))
    if mode.startswith("events"):
        return dict(ess_events=_events(t, r, rng), ess_edge=int(mode[6:]))
    return {}


def _check_health(t, r, mode, on, chunk=None, seed=0):
    args, hw, slew, dense, health = _inputs(t, r, seed=11 + r)
    mkw = _mode_kw(mode, t, r, np.random.default_rng(3))
    kw = dict(slew=slew, health=health) if on else dict(corrective=dense)
    want = ref.pdu_health_sim(*args, **kw, **mkw, **hw)
    mask = hw_plan.MASK_NONE if mode == "none" else (
        hw_plan.MASK_EVENTS if mode.startswith("events") else
        hw_plan.MASK_ROW if mode == "row" else hw_plan.MASK_SERIES)
    p = hw_plan.plan(r, mask) if chunk is None else hw_plan.plan(r, mask, chunk=chunk)
    got = emulate(*args, k=ref.hw_consts(**hw), plan=p, seed=seed, **kw, **mkw)
    names = ("grid", "soc", "g_f", "soc_f", "x_f")
    for name, a, b in zip(names, (got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} values differ"
    if on:
        for i, (a, b) in enumerate(zip(got[3], want[3][:6])):
            assert torch.equal(a, b), f"wear carry {i} differs"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("on", [True, False], ids=["slew+wear", "dense"])
@pytest.mark.parametrize("r", R_SHAPES)
@pytest.mark.parametrize("t", T_SHAPES)
def test_staged_pdu_health_matches_plain_at_ragged_shapes(t, r, mode, on):
    _check_health(t, r, mode, on)


@pytest.mark.parametrize("mode,on,r", [(m, True, 1) for m in MODES] + [
    ("none", False, 1), ("none", True, 1000), ("events50", True, 1000)])
def test_staged_pdu_health_matches_plain_at_the_quickstart_length(mode, on, r):
    """T = 2500: the quickstart's interval at R = 1 (the cp.async route,
    a copy spread over 32 samples), and a 1000-rack TMA run."""
    _check_health(2500, r, mode, on)


@pytest.mark.parametrize("chunk", [16, 64, 1, 96])
@pytest.mark.parametrize("seed", [1, 2])
def test_staged_schedule_is_the_same_at_every_chunk_and_interleaving(chunk, seed):
    _check_health(3 * chunk + 5, 35, "events50", True, chunk=chunk, seed=seed)
    _check_health(2 * chunk + 3, 36, "series", True, chunk=chunk, seed=seed)


# ---------------------------------------------------------------- pdu_sim


@pytest.mark.parametrize("variant", ["unweighted", "row", "series"])
@pytest.mark.parametrize("t,r", [(t, r) for t in T_SHAPES for r in R_SHAPES]
                         + [(2500, 1), (2500, 3)])
def test_staged_pdu_sim_matches_plain(t, r, variant):
    args, hw, _, dense, _ = _inputs(t, r, seed=5 + t)
    mkw = {} if variant == "unweighted" else _mode_kw(variant, t, r, np.random.default_rng(4))
    want = ref.pdu_sim(*args, dense, **mkw, **hw)
    mask = {"unweighted": hw_plan.MASK_NONE, "row": hw_plan.MASK_ROW,
            "series": hw_plan.MASK_SERIES}[variant]
    p = hw_plan.plan(r, mask)
    got = emulate(*args, k=ref.pdu_sim_consts(**hw), plan=p, corrective=dense, **mkw)
    for name, a, b in zip(("grid", "soc", "g_f", "soc_f", "x_f"), (got[0], got[1], *got[2]),
                          (want[0], want[1], *want[2])):
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} values differ"


# -------------------------------------------------------------- lc_filter

LC_S = hw_plan.lc_plan(1).chunk
LC_T_SHAPES = (1, 7, LC_S - 1, LC_S + 1)
# (loads, stores): the plan's two routes, and the two mixed ones that time
# each half of the cp.async route alone
LC_ROUTES = (("tma", "tma"), ("cp.async", "spread"), ("tma", "spread"), ("cp.async", "tma"))


def _check_lc(t, r, loads, stores, chunk=None, seed=0):
    args = _inputs(t, r, seed=7 + t + r)[0]
    node, x0, lc = args[0], args[3], args[4:7]
    want = ref.lc_filter(*lc, x0, node)
    kw = {} if chunk is None else dict(chunk=chunk)
    p = hw_plan.lc_plan(r, loads=loads, stores=stores, **kw)
    got = emulate_lc(x0, node, *lc, plan=p, seed=seed)
    for name, a, b in zip(("grid", "x_f"), got, want):
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} values differ"


@pytest.mark.parametrize("loads,stores", LC_ROUTES)
@pytest.mark.parametrize("r", R_SHAPES)
@pytest.mark.parametrize("t", LC_T_SHAPES)
def test_staged_lc_filter_matches_plain_at_ragged_shapes(t, r, loads, stores):
    """Every route at every ragged shape (the kernel itself refuses a TMA
    route at R % 4 != 0; emulated there, the zero fill and the clipped box
    stores still leave the bits)."""
    _check_lc(t, r, loads, stores)


@pytest.mark.parametrize("loads,stores", LC_ROUTES)
def test_staged_lc_filter_matches_plain_at_the_quickstart_length(loads, stores):
    """T = 2500, R = 1: a copy and a store spread over 32 samples."""
    _check_lc(2500, 1, loads, stores)


@pytest.mark.parametrize("chunk", [16, 64, 1, 96])
@pytest.mark.parametrize("seed", [1, 2])
def test_staged_lc_schedule_is_the_same_at_every_chunk_and_interleaving(chunk, seed):
    for i, (loads, stores) in enumerate(LC_ROUTES):
        _check_lc((3 + i) * chunk + 5, 35 + i, loads, stores, chunk=chunk, seed=seed)


def test_lc_plan_matches_the_header():
    """``hw_plan``'s LC constants are ``hw::LcLayout``'s (read from the
    source), and every chunk's plan holds its ring in the block's shared
    memory at the header's ``ring_bytes`` for that instantiation."""
    src = (_build._CSRC / "hw_stages.cuh").read_text()
    layout = src[src.index("struct LcLayout"):]
    layout = layout[:layout.index("};")]
    field = lambda name: int(re.search(rf"\b{name} = (\d+);", layout).group(1))
    assert (hw_plan.LC_N_IN, hw_plan.LC_N_OUT, hw_plan.LC_MBARRIERS, hw_plan.LC_WARPS) == (
        field("kIn"), field("kOut"), field("kBars"), field("kWarps"))
    assert re.search(r"ring_bytes\(chunk, slots, L::kIn, L::kOut, L::kBars\)",
                     (_build._CSRC / "lc_filter.cu").read_text())
    for chunk in range(1, hw_plan.MAX_CHUNK + 1):
        p = hw_plan.lc_plan(1024, chunk=chunk)
        ring = p.slots * (field("kIn") + field("kOut")) * chunk * 32 * 4 + field("kBars") * p.slots * 8
        assert p.smem_bytes == ring <= hw_plan.SMEM_LIMIT == 232_448
        assert p.chunk == chunk and p.slots >= 2 and p.slots * chunk >= hw_plan.AHEAD
    assert hw_plan.lc_plan(1024)[3:] == ("tma", "tma")
    for r in (1, 3, 33, 1026):
        assert hw_plan.lc_plan(r)[3:] == ("cp.async", "spread")
    assert hw_plan.lc_plan(1024, aligned=False)[3:] == ("cp.async", "spread")
    assert hw_plan.lc_plan(1, loads="tma", stores="spread")[3:] == ("tma", "spread")
    assert hw_plan.lc_launch_args(hw_plan.lc_plan(1024, chunk=64, stores="spread")) == (
        64, 3, 1, 0, hw_plan.lc_plan(1024, chunk=64).smem_bytes)
    for kw in (dict(chunk=0), dict(chunk=hw_plan.MAX_CHUNK + 1), dict(loads="spread"),
               dict(stores="cp.async")):
        with pytest.raises(ValueError):
            hw_plan.lc_plan(8, **kw)


# ------------------------------------------------------------ launch plan


@pytest.mark.parametrize("chunk", [16, 32, 64, hw_plan.CHUNK])
def test_plan_fits_every_instantiation(chunk):
    """Every weight mode of pdu_health (0-3; the slew and the wear fold
    change no slot array) and of pdu_sim (0-2) fits the block's shared
    memory with a ring at least two slots and, where it fits, ``AHEAD``
    samples deep."""
    for mask in range(4):
        p = hw_plan.plan(1024, mask, chunk=chunk)
        assert p.smem_bytes <= hw_plan.SMEM_LIMIT == 232_448
        assert p.chunk == chunk and p.slots >= 2 and p.slots * chunk >= hw_plan.AHEAD
        assert p.n_in == 4 + (mask in (2, 3))
        assert p.smem_bytes == hw_plan.smem_bytes(p.chunk, p.slots, p.n_in)
    assert hw_plan.plan(8, 0) == hw_plan.plan(8, 0, chunk=hw_plan.CHUNK)
    # the largest instantiation: two slots of 96 samples fit, of 128 they do
    # not, and the plan refuses rather than shrink them
    p = hw_plan.plan(8, hw_plan.MASK_SERIES, chunk=96)
    assert p.slots == 2 and p.smem_bytes <= hw_plan.SMEM_LIMIT
    for mask, ch in ((hw_plan.MASK_SERIES, 128), (0, 0), (0, hw_plan.MAX_CHUNK + 1), (4, 64)):
        with pytest.raises(ValueError):
            hw_plan.plan(8, mask, chunk=ch)


def test_load_route_follows_the_row_stride():
    for r in range(1, 130):
        p = hw_plan.plan(r, hw_plan.MASK_NONE)
        assert p.route == ("tma" if r % 4 == 0 else "cp.async"), r
        assert hw_plan.plan(r, hw_plan.MASK_SERIES, aligned=False).route == "cp.async"
    assert hw_plan.launch_args(hw_plan.plan(1024, 0))[2] == 1
    assert hw_plan.launch_args(hw_plan.plan(1, 0))[2] == 0
    base = torch.zeros(64)
    assert hw_plan.aligned(base, None) and not hw_plan.aligned(base[1:])


def test_spread_copies_cover_each_chunk_once():
    """The lane map of the cp.async route's copies and of its chunk stores
    (``csrc/hw_stages.cuh``: lane = t_off * rb + j handles rack j of rows
    t_off, t_off + 32 // rb, ...): for every rack count of a block and
    every chunk length, each (row, rack) of the chunk once, and nothing
    past the chunk's rows or the block's racks."""
    racks = hw_plan.RACKS
    for rb in range(1, racks + 1):
        rows = racks // rb
        for n in (1, 7, S - 1, S):
            seen = []
            for lane in range(racks):
                j, t_off = lane % rb, lane // rb
                if t_off >= rows:
                    continue
                seen += [(t, j) for t in range(t_off, n, rows)]
            assert sorted(seen) == [(t, j) for t in range(n) for j in range(rb)], (rb, n)


# ----------------------------------------------------------- the build


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """An edited header a source includes changes the library's name, so a
    stale library is never loaded; a header no source includes does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "stages.cuh"\n#include <cuda_runtime.h>\nint a;\n')
    (csrc / "stages.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("constexpr int k = 1;\n")
    (csrc / "other.cuh").write_text("constexpr int j = 1;\n")
    monkeypatch.setattr(_build, "_CSRC", csrc.resolve())
    monkeypatch.setattr(_build, "SOURCES", {"a": ("a.cu", [])})
    assert [p.name for p in _build._sources("a.cu")] == ["a.cu", "stages.cuh", "inner.cuh"]
    first = _build._lib_path("a")
    (csrc / "other.cuh").write_text("constexpr int j = 2;\n")
    assert _build._lib_path("a") == first
    (csrc / "inner.cuh").write_text("constexpr int k = 2;\n")
    second = _build._lib_path("a")
    assert second != first
    (csrc / "stages.cuh").write_text('#pragma once\n#include "inner.cuh"\n// edited\n')
    assert _build._lib_path("a") not in (first, second)
