"""Plain reference of the ``lm`` configurations (hymba-1.5b-base), and the
check that decides ``correct``.

The reference is the full forward pass of the published structure over
one whole sequence: float32, no kernel, no cache, no batching, the
selective scan one position at a time.  It imports nothing: it computes
with the methods of the tensors it is handed, the weights that the
traffic kind drew from the seed on the run's device
(``yardstick/kinds/serve.py``, which also turns TF32 off, so that float32
products here are float32), and it shares no code with the program.

The model, config keys in brackets.  A sequence is the M = [meta_tokens]
meta vectors followed by the text tokens; position P counts from the
first meta vector, so text position p sits at M + p.

  x = [meta | sqrt(d) embed[tokens]]                          d = [d_model]
  each layer l:
    h        = RMSNorm(x) attn_norm                           eps [norm_eps]
    q, k, v  = RoPE(h wq), RoPE(h wk), h wv   [n_heads] and [n_kv_heads] heads
               of [head_dim]; rotate-half RoPE at [rope_theta] by position
               a layer of a [kv_groups] run after its first takes the
               first's k and v (projected from the first's own h)
    attn     = softmax(q k^T / sqrt(hd), keys j <= P; outside
               [global_layers] only j < M or j > P - [sliding_window]) v wo
    u, z     = split(h in_proj)                   e = [mamba_expand] d each
    u        = SiLU(causal depthwise conv of [ssm_conv] taps over u)
    B, C, dt = split(u x_proj)                   [ssm_state], [ssm_state], 1
    s_t      = exp(softplus(dt_t) A) s_(t-1) + softplus(dt_t) B_t u_t,
               A = -exp(a_log), s_0 = 0 before the first meta vector
    mamba    = ((C_t . s_t + d_skip u_t) SiLU(z)) out_proj
    x       += (RMSNorm(attn) + RMSNorm(mamba)) / 2       (norms unweighted)
    x       += (SiLU(h2 w_gate) (h2 w_up)) w_down,  h2 = RMSNorm(x) ffn_norm
  logits = (RMSNorm(x) final_norm) embed^T                (tied embeddings)

The check teacher-forces every sequence served in the window (its prompt
and the tokens it was served) and compares the logits each token was
chosen from with the float32 reference's at that position (relative L2),
and with the spread of the witness runs there (:class:`Witness`: the
largest distance between float32, bf16 and dithered bf16 runs of the
reference).  A step's excess is 0 within ``STEP_TOL`` (5e-2, the port's
on-chip bound for bf16 logits, ``chip_smoke.LOGITS_REL_TOL``), else its
distance over the spread.  For each sequence still in a slot it compares
the global-layer k/v that the SiM-paged pool gives back with the
reference's, position by position, the same way; and it counts the pool's
pages against those the live sequences hold.  The limits, and why (H100
runs of the cell at 51 s windows; the readings in PERF.md):

- ``logit_sequences_beyond``, 0: the sequences (those with at least
  ``MIN_STEPS`` steps; the shorter pooled into one group) whose median
  excess is above ``WITNESS_FACTOR`` (1.5, ``chip_smoke.WITNESS_FACTOR``).
  With random weights the 32-layer bf16 model amplifies rounding: the
  program reads 0.025-0.75 from float32 (median 0.08-0.10, 75-85 % of
  steps over 5e-2), and a single step's distance over the spread reached
  1.6-2.0, so 1.5 cannot bound every step; a sequence's median reads at
  most 0.91, while a global layer on a ring of the window's slots reads
  4.2-6.7 on the long sessions that pass it.
- ``logit_steps_beyond``, 0: the steps whose excess is above
  ``TAIL_FACTOR`` (4): a wrong first token or a fault every page's worth
  of steps, which a median lets through (a wrong step reads some 1-1.4
  over a spread whose median is 0.2-0.4).  A sound run's largest step
  read 1.37-2.62 over six runs of some 500 steps; 4 is 1.5x that, and a
  Gumbel fit of those six maxima puts a sound run above it ~0.2 % of
  the time (above 3, ~3 %).  The float8 and global-ring controls have
  107-240 steps above 3.
- ``logit_rel_l2_median``, 0.25: the median step over all sequences; the
  program reads 0.079-0.103, the reference with float8 (e4m3) products,
  a precision below the configuration's bf16, 0.58-0.74.
- ``kv_positions_off``, 0: the positions whose k/v in the first global
  layer's cache (layer 0, which reads the embeddings alone) is beyond
  STEP_TOL: the program's largest read 0.0041 over six runs of some
  15,000 positions; a position paged to a wrong slot, left unwritten or
  overwritten reads near 1 (336 positions in the unwritten-decodes
  control).
- ``kv_pages_off``, 0: the pages of a global cache whose positions'
  median excess is above ``PAGE_FACTOR`` (3): a deeper cache's page that
  holds another's k/v, where single positions stray as the logits do.
  Sound runs' largest page median read 1.13-1.38 over six runs of some
  2,800 pages; the global-ring control has 1,187 pages above 3, float8
  2,502.
- ``kv_pages_unaccounted``, 0: the pool's pages neither on its free list
  nor holding a live sequence's positions (a retired sequence's pages not
  freed, or a live one's freed).

:data:`CONTROLS` put the reference in the program's place with one of
these broken (``simbench/control.py``).
"""
from __future__ import annotations

STEP_TOL = 5e-2
WITNESS_FACTOR = 1.5
TAIL_FACTOR = 4.0
PAGE_FACTOR = 3.0
MIN_STEPS = 8           # a sequence with fewer steps is judged in a pool
WITNESS_DITHERS, DITHER = 2, 2.0 ** -9
MEDIAN_TOL = 0.25
Q_CHUNK = 1024          # query rows a score block holds
SCAN_CHUNK = 256        # positions whose decays are held at once


def _same(t):
    return t


class Single:
    """One run (a leading axis of 1): ``products`` rounds what a program in
    a lower precision would hold (the inputs and output of every matrix
    product, the norms', RoPE's, SiLU's, the conv's, the attention
    probabilities' and outputs' and the scan's), ``stream`` the residual
    stream after each residual add; both the identity by default (float32
    throughout)."""
    n = 1

    def __init__(self, products=_same, stream=_same):
        self.products, self.stream, self.weight = products, stream, products


def _hashed(like, n: int, *salt):
    """(n,) uniform values in [0, 1) from an integer hash of each index and
    ``salt``, on ``like``'s device."""
    i = like.new_ones(n).long().cumsum(0)
    h = i * 0x9E3779B1
    for k, v in zip((0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F), salt):
        h = h + v * k
    h = h % (1 << 32)
    h = ((h ^ (h >> 15)) * 0x2C1B3C6D) % (1 << 32)
    return h.float() * 2.0 ** -32


class Witness:
    """The reference runs whose spread witnesses a step, side by side along
    a leading axis: run 0 float32; run 1 bf16 products over a float32
    residual stream; run 2 bf16 both; runs 3.. (``WITNESS_DITHERS``) bf16
    both, each value first scaled by 1 + u DITHER, u in [-1, 1) drawn
    afresh for every call and run (frac(a_row + b_column) of two sequences
    cut from a hashed bank at offsets set by the call): other roundings of
    the same size.  Made afresh for each check, so that a check reads the
    same on the same inputs."""
    BANK = 1 << 20

    def __init__(self, like):
        self.n = 3 + WITNESS_DITHERS
        self.calls = 0
        bank = _hashed(like, self.BANK, 7)
        self.bank = bank.new_empty(2 * self.BANK)      # twice, so that a
        self.bank[:self.BANK] = bank                   # cut never wraps
        self.bank[self.BANK:] = bank

    def _cut(self, length: int, salt: int):
        at = (self.calls * 7919 + salt * 104729) % self.BANK
        return self.bank[at:at + length]

    def _round(self, t, first: int):
        """Runs ``first``.. of t (runs, ...) rounded, the dithered ones
        dithered first."""
        self.calls += 1
        out = t.new_empty(t.shape)
        out[:first] = t[:first]
        out[first:3] = t[first:3].bfloat16().float()
        tail = t[3:].reshape(self.n - 3, -1, t.shape[-1])
        u = tail.new_empty(tail.shape)
        rows = self._cut(tail.shape[1], 0)
        for i in range(self.n - 3):
            u[i] = rows[:, None] + self._cut(tail.shape[2], i + 1)
        u = u.frac() * 2 - 1
        out[3:] = (tail * (1 + u * DITHER)).bfloat16().float().view(
            t[3:].shape)
        return out

    def products(self, t):
        return self._round(t, 1)

    def stream(self, t):
        return self._round(t, 2)

    def weight(self, w):
        return self.products(w[None].expand(self.n, *w.shape))


def _rms(x, w, eps: float):
    y = x * (x * x).mean(-1, keepdim=True).add(eps).rsqrt()
    return y if w is None else y * w.float()


def _rope(x, pos, theta: float):
    """x (..., T, H, hd) float32 rotated by positions ``pos`` (T,) float32:
    the first half of each head against the second."""
    half = x.shape[-1] // 2
    freqs = theta ** (-(pos.new_tensor(list(range(half))) / half))
    ang = pos[:, None, None] * freqs
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x[..., :half], x[..., half:]
    out = x.new_empty(x.shape)
    out[..., :half] = x1 * cos - x2 * sin
    out[..., half:] = x2 * cos + x1 * sin
    return out


def _attention(q, k, v, pos, m: int, window, r):
    """Causal attention of every position of one sequence, q (R, T, H, hd),
    k, v (R, T, Hkv, hd); with ``window`` a query at P sees only keys j < m
    or j > P - window; the probabilities rounded by ``r`` before their
    product with v, as a bf16 program holds them.  In blocks of Q_CHUNK
    query rows; a window's block leaves out the keys that none of its rows
    sees."""
    t, h, hd = q.shape[1:]
    group = h // k.shape[2]
    q = q.transpose(1, 2)                                  # (R, H, T, hd)
    k = k.repeat_interleave(group, 2).transpose(1, 2)
    v = v.repeat_interleave(group, 2).transpose(1, 2)
    out = q.new_empty(q.shape)
    for i in range(0, t, Q_CHUNK):
        j = min(i + Q_CHUNK, t)
        lo = m if window is None else max(m, i - window + 1)
        kc, vc, kp = k[:, :, :j], v[:, :, :j], pos[None, :j]
        if lo > m:              # keys between that no query of the block sees
            kc, vc = (c.new_empty(c.shape[:2] + (m + j - lo,) + c.shape[3:])
                      for c in (kc, vc))
            for c, src in ((kc, k), (vc, v)):
                c[:, :, :m] = src[:, :, :m]
                c[:, :, m:] = src[:, :, lo:j]
            kp = kp.new_empty((1, m + j - lo))
            kp[0, :m], kp[0, m:] = pos[:m], pos[lo:j]
        qp = pos[i:j, None]
        keep = kp <= qp
        if window is not None:
            keep = keep & ((kp < m) | (kp > qp - window))
        s = (q[:, :, i:j] @ kc.transpose(2, 3)) * hd ** -0.5
        p = r(s.masked_fill(~keep, float("-inf")).softmax(-1))
        out[:, :, i:j] = p @ vc
    return out.transpose(1, 2)


def _scan(u, delta, a, bm, cm):
    """The selective scan over one sequence, one position at a time:
    u (R, T, e), delta (R, T, 1), a (e, N), bm, cm (R, T, N); returns
    C_t . s_t (R, T, e).  The states of SCAN_CHUNK positions are held at
    once."""
    t = u.shape[1]
    y = u.new_empty(u.shape)
    state = u.new_zeros((u.shape[0],) + a.shape)
    for i in range(0, t, SCAN_CHUNK):
        j = min(i + SCAN_CHUNK, t)
        dec = (delta[:, i:j, :, None] * a).exp()           # (R, c, e, N)
        s = (delta[:, i:j] * u[:, i:j])[..., None] * bm[:, i:j, None, :]
        steps, decays = s.unbind(1), dec.unbind(1)
        steps[0].addcmul_(decays[0], state)
        for r in range(1, j - i):
            steps[r].addcmul_(decays[r], steps[r - 1])
        state = steps[-1]
        y[:, i:j] = (s * cm[:, i:j, None, :]).sum(-1)
    return y


def _silu(x):
    return x * x.sigmoid()


def _mamba(lw, h, config, mm, r):
    e = lw["out_proj"].shape[0]
    n = int(config["ssm_state"])
    taps = lw["conv"].float()                                  # (K, e)
    xz = mm(h, lw["in_proj"])
    u, z = xz[..., :e], xz[..., e:]
    t, k = u.shape[1], taps.shape[0]
    padded = u.new_zeros((u.shape[0], t + k - 1, e))
    padded[:, k - 1:] = u
    conv = r(padded[:, 0:t] * taps[0])
    for i in range(1, k):
        conv = r(conv + r(padded[:, i:i + t] * taps[i]))
    u = r(_silu(conv))
    proj = mm(u, lw["x_proj"])
    bm, cm, dt = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n:]
    delta = dt.logaddexp(dt.new_zeros(dt.shape))              # softplus
    a = -lw["a_log"].float().exp()
    y = r(_scan(u, delta, a, bm, cm) + u * lw["d_skip"].float())
    return mm(r(y * r(_silu(z))), lw["out_proj"])


def forward_runs(config: dict, weights: dict, tokens: list, rows: int,
                 rounding=None, *, kv: bool = False,
                 global_window: bool = False):
    """Logits (R, rows, vocab) float32 of the last ``rows`` positions of
    the sequence [meta | ``tokens``] for each of the R runs of
    ``rounding`` (a :class:`Single` or a :class:`Witness`; float32 when
    None).  The runs share nothing but their inputs: they are computed
    side by side along a leading axis.  With ``kv``, also each global
    layer's k/v (those of a layer that projects its own, in layer order)
    over the text positions: (logits, [(k, v)]), each (R, len(tokens),
    Hkv, hd), k after RoPE.  ``global_window``: the global layers attend
    as the window layers do (a control, :data:`CONTROLS`)."""
    rounding = Single() if rounding is None else rounding
    r, stream = rounding.products, rounding.stream
    w = weights
    d, m = int(config["d_model"]), int(config["meta_tokens"])
    t, n_runs = m + len(tokens), rounding.n
    h_q, h_kv = int(config["n_heads"]), int(config["n_kv_heads"])
    hd, eps = int(config["head_dim"]), float(config["norm_eps"])
    theta, window = float(config["rope_theta"]), int(config["sliding_window"])
    first = {i: g[0] for g in config["kv_groups"] for i in g}
    paged = [i for i in sorted(config["global_layers"])
             if first.get(i, i) == i]
    glob = set() if global_window else set(config["global_layers"])

    def mm(a, b):
        return r(r(a) @ rounding.weight(b.float()))

    embed = w["embed"]
    x = w["meta"].float().new_empty((n_runs, t, d))
    x[:, :m] = w["meta"].float()
    x[:, m:] = embed[tokens].float() * d ** 0.5
    x = stream(x)
    pos = x.new_tensor(list(range(t)))
    shared = {}
    for lid, lw in enumerate(w["layers"]):
        h = r(_rms(x, lw["attn_norm"], eps))
        q = r(_rope(mm(h, lw["wq"]).view(n_runs, t, h_q, hd), pos, theta))
        if first.get(lid, lid) == lid:
            k = mm(h, lw["wk"]).view(n_runs, t, h_kv, hd)
            shared[lid] = (r(_rope(k, pos, theta)),
                           mm(h, lw["wv"]).view(n_runs, t, h_kv, hd))
        k, v = shared[first.get(lid, lid)]
        att = r(_attention(q, k, v, pos, m, None if lid in glob else window,
                           r))
        att = mm(att.reshape(n_runs, t, h_q * hd), lw["wo"])
        mamba = _mamba(lw, h, config, mm, r)
        x = stream(x + 0.5 * (r(_rms(att, None, eps))
                              + r(_rms(mamba, None, eps))))
        h2 = r(_rms(x, lw["ffn_norm"], eps))
        ff = mm(r(_silu(mm(h2, lw["w_gate"]))) * mm(h2, lw["w_up"]),
                lw["w_down"])
        x = stream(x + ff)
    out = _rms(x[:, t - rows:], w["final_norm"], eps)
    logits = mm(out, embed.transpose(0, 1))
    if not kv:
        return logits
    return logits, [tuple(c[:, m:] for c in shared[i]) for i in paged]


def forward(config: dict, weights: dict, tokens: list, rows: int, *,
            products=_same, stream=_same):
    """:func:`forward_runs` of one run (:class:`Single`'s roundings):
    logits (rows, vocab)."""
    return forward_runs(config, weights, tokens, rows,
                        Single(products, stream))[0]


def _rel(a, b):
    """Relative L2 distance of each row of ``a`` from ``b``'s."""
    return (a.float() - b.float()).norm(dim=-1) / b.float().norm(dim=-1)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def _spread(runs):
    """Each row's largest relative L2 distance between two of the runs
    (R, rows, ...)."""
    out = None
    for ai in range(len(runs)):
        for b in runs[ai + 1:]:
            d = _rel(runs[ai], b)
            out = d if out is None else out.maximum(d)
    return out


def _excess(rel, spread):
    """0 where ``rel`` is within STEP_TOL, else ``rel`` over ``spread``."""
    return (rel / spread.clamp_min(1e-30)).masked_fill(rel <= STEP_TOL, 0.0)


def _pool_rows(c):
    """A pool tensor (positions, Hkv, hd) or a reference run's (R,
    positions, Hkv, hd) as rows of a position."""
    return c.reshape(c.shape[:-2] + (-1,))


def _judge_kv(config, pool, ref_kv):
    """The positions whose first global cache is beyond STEP_TOL, the pages
    of any global cache whose median excess is beyond PAGE_FACTOR, the
    positions and pages judged, the first cache's largest distance and the
    largest page median: a sequence's pool ``pool`` (k, v), each (caches,
    positions, Hkv, hd), against the reference runs' ``ref_kv``."""
    page = int(config["page_tokens"])
    gk, gv = pool
    n = gk.shape[1]
    want = ref_kv[0][0].shape[1]
    off = abs(n - want) + (len(ref_kv) != gk.shape[0])
    n = min(n, want)
    pages_off, worst0, worst_page = 0, 0.0, 0.0
    for c, (rk, rv) in enumerate(ref_kv[:gk.shape[0]]):
        rel = exc = None
        for got, ref in ((gk[c, :n], rk[:, :n]), (gv[c, :n], rv[:, :n])):
            ref = _pool_rows(ref)
            r = _rel(_pool_rows(got).to(ref.device), ref[0])
            e = _excess(r, _spread(ref))
            rel = r if rel is None else rel.maximum(r)
            exc = e if exc is None else exc.maximum(e)
        if c == 0:
            off += int((~(rel <= STEP_TOL)).sum())
            worst0 = max(worst0, float(rel.max()))
        medians = [exc[i:i + page].median() for i in range(0, n, page)]
        pages_off += sum(not float(x) <= PAGE_FACTOR for x in medians)
        worst_page = max([worst_page] + [float(x) for x in medians])
    return off, pages_off, n, -(-n // page) * len(ref_kv), worst0, \
        worst_page


def check(config: dict, inputs, executed: dict, got: dict):
    """Compared numbers ``{name: (value, limit)}``, the window's tokens of
    the sequences beyond a limit, and what was compared.

    ``executed["sequences"]``: each served sequence's ``prompt``, the
    tokens it was ``served`` and ``window_from``, the index of its first
    token served inside the window.  ``got["logits"]``: for each, the
    (served, vocab) logits each token was chosen from; ``got["kv"]``: for
    each sequence still in a slot (else None), its global-layer (k, v) as
    the paged pool gives them back, each (caches, positions, Hkv, hd), the
    positions of its prompt and of every token it was served but the last;
    ``got["pages_free"]``: the pool's free pages.  Only the sequences
    served in the window are judged; every live one's pages are counted."""
    w = inputs.weights
    page = int(config["page_tokens"])
    steps, groups, pooled, witnessed, held = [], [], [], 0, 0
    flagged, tail_steps, kv_off, pages_off = set(), 0, 0, 0
    judged = {"judged_sequences": 0, "kv_positions": 0, "kv_pages": 0}
    worst = {"step_excess": 0.0, "first_cache_rel": 0.0,
             "page_median_excess": 0.0}
    for i, (seq, logits, pool) in enumerate(zip(
            executed["sequences"], got["logits"], got["kv"])):
        n = len(seq["served"])
        window = n - min(seq["window_from"], n)
        if pool is not None:
            held += -(-pool[0].shape[1] // page)
        if not window:
            continue
        judged["judged_sequences"] += 1
        feed = list(seq["prompt"]) + list(seq["served"][:-1])
        runs, ref_kv = forward_runs(config, w, feed, n, Witness(w["embed"]),
                                    kv=True)
        witnessed += len(runs) - 1
        rel = _rel(logits.to(runs.device), runs[0])
        excess = _excess(rel, _spread(runs))
        beyond = int((~(excess <= TAIL_FACTOR)).sum())
        tail_steps += beyond
        worst["step_excess"] = max(worst["step_excess"], float(excess.max()))
        steps += rel.tolist()
        if pool is not None:
            off, poff, npos, npg, w0, wp = _judge_kv(config, pool, ref_kv)
            kv_off, pages_off = kv_off + off, pages_off + poff
            judged["kv_positions"] += npos
            judged["kv_pages"] += npg
            worst["first_cache_rel"] = max(worst["first_cache_rel"], w0)
            worst["page_median_excess"] = max(
                worst["page_median_excess"], wp)
            beyond += off + poff
        if beyond:
            flagged.add(i)
        (groups if n >= MIN_STEPS else pooled).append(
            ([i], excess.tolist()))
    if pooled:
        groups.append(([i for ids, _ in pooled for i in ids],
                       [e for _, ex in pooled for e in ex]))
    for ids, ex in groups:
        if not _median(ex) <= WITNESS_FACTOR:
            flagged.update(ids)
    unaccounted = abs(int(config["kv_pages"]) - int(got["pages_free"])
                      - held)
    numbers = {
        "logit_sequences_beyond": (sum(
            not _median(ex) <= WITNESS_FACTOR for _, ex in groups), 0),
        "logit_steps_beyond": (tail_steps, 0),
        "logit_rel_l2_median": (_median(steps), MEDIAN_TOL),
        "kv_positions_off": (kv_off, 0),
        "kv_pages_off": (pages_off, 0),
        "kv_pages_unaccounted": (unaccounted, 0)}
    seqs = executed["sequences"]
    failed = sum(len(seqs[i]["served"]) - min(seqs[i]["window_from"],
                                              len(seqs[i]["served"]))
                 for i in flagged)
    compared = {
        "sequences": len(seqs), "steps": len(steps),
        "groups": len(groups),
        "worst_group_median_excess": max(
            (_median(ex) for _, ex in groups), default=None),
        "steps_over_step_tol": sum(not r <= STEP_TOL for r in steps),
        "steps_beyond_witness": sum(e > WITNESS_FACTOR
                                    for _, ex in groups for e in ex),
        "worst_step": max(steps) if steps else None,
        "witness_runs": witnessed, "pages_held": held,
        "pages_free": int(got["pages_free"]), **judged,
        **{f"worst_{k}": v for k, v in worst.items()}}
    return numbers, failed, compared


# ---------------------------------------------------------------- controls

def _schedule(config: dict, inputs, n_tokens: int) -> list:
    """The sequences a run that serves ``n_tokens`` window tokens serves,
    as the closed loop hands them over: (prompt, tokens served, of them
    before the window, still in a slot).  The warm-up requests are served
    whole before the window; each slot's first request gets its first
    token at set-up; in the window each live slot gets a token a step, and
    a slot whose short request has all its tokens takes the next."""
    out = [[p, a, a, a, False] for p, a in inputs.warmup_requests]
    queue = iter(inputs.short)
    live = [[p, inputs.long_new_tokens, 1, 1, True]
            for p in inputs.long_prompts]
    while len(live) < int(config["max_slots"]):
        new = next(queue, None)
        if new is None:
            break
        live.append([new[0], new[1], 1, 1, True])
    out += live
    done = 0
    while done < n_tokens and live:
        for s in list(live):
            if done == n_tokens:
                break
            s[2] += 1
            done += 1
            if s[2] >= s[1]:
                s[4] = False
                live.remove(s)
                new = next(queue, None)
                if new is not None:
                    live.append([new[0], new[1], 0, 0, True])
                    out.append(live[-1])
    return [(s[0], s[2], s[3], s[4]) for s in out]


def _answers(config: dict, inputs, executed: dict, products=_same,
             global_window: bool = False, unwritten: bool = False,
             leak: bool = False) -> dict:
    """A control's answers: the reference (``products``, ``global_window``)
    in the program's place over the sequences of :func:`_schedule` (which
    it writes into ``executed``: greedy decoding is not replayed, the
    served tokens are hashed from the sequence's index), the pool holding
    its global k/v; ``unwritten``: the pool's decoded positions were never
    written (they read 0); ``leak``: the pages of the sequences that left
    their slot never came back to the free list."""
    w = inputs.weights
    page, vocab = int(config["page_tokens"]), int(config["vocab_size"])
    seqs = _schedule(config, inputs, len(executed["window"]))
    executed["sequences"] = []
    got = {"logits": [], "kv": []}
    free, gone = int(config["kv_pages"]), 0
    for i, (prompt, n, before, live) in enumerate(seqs):
        served = (_hashed(w["embed"], n, 11, i) * vocab).long().tolist()
        executed["sequences"].append({"prompt": prompt, "served": served,
                                      "window_from": before})
        feed = list(prompt) + served[:-1]
        pages = -(-len(feed) // page)
        if not live:
            gone += pages
        if n == before and not live:
            got["logits"].append(None)
            got["kv"].append(None)
            continue
        logits, kv = forward_runs(config, w, feed, n, Single(products),
                                  kv=True, global_window=global_window)
        got["logits"].append(logits[0])
        pool = None
        if live:
            free -= pages
            pool = tuple(c[0].new_empty((len(kv),) + c[0].shape)
                         for c in kv[0])
            for c, pair in enumerate(kv):
                for dst, src in zip(pool, pair):
                    dst[c] = src[0]
                    if unwritten:
                        dst[c, len(prompt):] = 0
        got["kv"].append(pool)
    got["pages_free"] = free - (gone if leak else 0)
    return got


def _always(inputs, executed) -> bool:
    return True


def _long_past_window(inputs, executed) -> bool:
    return any(len(p) > int(inputs.config["sliding_window"])
               for p in inputs.long_prompts)


def _float8(t):
    """Rounding to float8 e4m3 (3 mantissa bits, exponents down to -6,
    saturated at 448), the precision below the configuration's bf16: to
    the nearest, ties to even."""
    step = (t.abs().log2().floor().clamp_min(-6) - 3).exp2()
    return ((t / step).round() * step).clamp(-448, 448)


# The controls (``simbench/control.py``): {name: (answers, applies)}.
CONTROLS = {
    "float8_products": (
        lambda c, i, e: _answers(c, i, e, products=_float8), _always),
    "global_ring": (
        lambda c, i, e: _answers(c, i, e, global_window=True),
        _long_past_window),
    "unwritten_decodes": (
        lambda c, i, e: _answers(c, i, e, unwritten=True), _always),
    "unfreed_pages": (lambda c, i, e: _answers(c, i, e, leak=True), _always),
}
