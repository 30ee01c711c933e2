"""The sharded path's edge cases, built with numpy from one seed, for
tests/test_torch_sharded_select.py, tests/test_torch_sharded_scan_cache.py
and chip_smoke.py's sharded phase: K7e's selection cases as
`place_bulk_batch_sharded` operands, K7a's cache cases as
`place_batch_sharded` operands, K7d's run cases as one wave's shards."""
import numpy as np

SELECT_EVALS = 3                    # evals a lane in every case
SELECT_DELTAS = 8                   # delta slots an eval in every case
_SELECT_CAP = (4000.0, 8192.0, 100000.0, 1000.0)
_SELECT_DEMAND = (500.0, 256.0, 0.0, 0.0)


def _select_lanes(n_rows: int, lanes) -> dict:
    """place_bulk_batch_sharded's [W, E, ...] operands from `lanes`, one
    list a lane of eval dicts (count, and any of feasible, affinity,
    has_affinity, penalty, coll0, demand, desired, deltas = [(row,
    f32[4])]); unset fields: every row feasible, the C2M demand, desired
    = count, no deltas (pad rows n_rows)."""
    W, E, D, N = len(lanes), SELECT_EVALS, SELECT_DELTAS, n_rows
    f = dict(feasible=np.ones((W, E, N), bool),
             affinity=np.zeros((W, E, N), np.float32),
             has_affinity=np.zeros((W, E), bool),
             desired=np.ones((W, E), np.int32),
             penalty=np.zeros((W, E, N), bool),
             coll0=np.zeros((W, E, N), np.int32),
             demand=np.zeros((W, E, 4), np.float32),
             count=np.zeros((W, E), np.int32),
             delta_rows=np.full((W, E, D), N, np.int32),
             delta_vals=np.zeros((W, E, D, 4), np.float32))
    for w, evals in enumerate(lanes):
        for e, ev in enumerate(evals):
            f["count"][w, e] = ev["count"]
            f["desired"][w, e] = max(ev["count"], 1)
            f["demand"][w, e] = _SELECT_DEMAND
            for k, v in ev.items():
                if k == "deltas":
                    for d, (r, val) in enumerate(v):
                        f["delta_rows"][w, e, d] = r
                        f["delta_vals"][w, e, d] = val
                elif k != "count":
                    f[k][w, e] = v
    return f


def bulk_select_cases(n_rows: int, node_shards: int, lanes: int,
                      seed: int = 0) -> list:
    """The selection cases of K7e as `place_bulk_batch_sharded` operands
    on an (node_shards, lanes) mesh: [(label, capacity f32[N, 4], used
    f32[N, 4], fields {name: [W, E, ...] numpy}, spread_algorithm)], every
    lane SELECT_EVALS evals (count-0 pads after), SELECT_DELTAS delta
    slots an eval.  n_rows a multiple of node_shards, at least 16 rows a
    shard.  The cases: a tie wave with more tied rows than `remaining`;
    a strict wave whose rows all share the top score; a strict wave whose
    threshold splits the rows of one score, across a shard boundary; a
    `remaining` of at least the wave; scores of exactly 0.0 at the top;
    lane pads of count 0 with deltas; delta rows that repeat a row (in an
    order that rounds differently); a usage row at +inf under deltas;
    fitting rows that score NaN at m = 1, at m = 2 only, and on one shard
    between finite scores on the others (spread waves); every fitting row
    scoring -inf (an affinity of -inf) among rows that do not fit."""
    rng = np.random.default_rng(seed)
    N, NS, W = n_rows, node_shards, lanes
    n = N // NS
    assert n * NS == N and n >= 16
    d = np.asarray(_SELECT_DEMAND, np.float32)
    cap = np.tile(np.asarray(_SELECT_CAP, np.float32), (N, 1))
    zero = np.zeros((N, 4), np.float32)
    cases = []

    def ev(count, **kw):
        return dict(count=count, **kw)

    def some_infeasible():
        return rng.random(N) >= 0.02

    # every row empty: binpack scores them equal (a tie wave); spread
    # scores m = 1 above m = 2, so the wave is strict and all at the top
    cases.append(("tie wave, more tied rows than remaining", cap, zero,
                  _select_lanes(N, [[ev(5 + w, feasible=some_infeasible()),
                                     ev(3), ev(0)] for w in range(W)]),
                  False))
    cases.append(("strict wave, every wave row at the top score", cap, zero,
                  _select_lanes(N, [[ev(7 + w), ev(2 + w), ev(0)]
                                    for w in range(W)]), True))

    # spread: rows A empty (the top), rows B half a demand used (their m = 1
    # beats A's m = 2: in the strict wave, below A), the rest 3 demands
    # used (out of it); B straddles the boundary of shards 0 and 1
    split = zero.copy()
    split[:] = 3 * d
    a_rows = [2, n + 9, N - 3]
    b_rows = [n - 2, n - 1, n, n + 1, n + 2]
    split[a_rows] = 0.0
    split[b_rows] = d / 2
    cases.append(("strict wave, threshold splits one score across a shard "
                  "boundary", cap, split,
                  _select_lanes(N, [[ev(6 + w), ev(4), ev(0)]
                                    for w in range(W)]), True))
    cases.append(("remaining at least the wave", cap, split,
                  _select_lanes(N, [[ev(8 + 5 * w), ev(20), ev(0)]
                                    for w in range(W)]), True))

    # binpack with affinity: rows Z become full with one instance and carry
    # a penalty, so they score exactly 0.0 (fit 1, penalty -1, over 2);
    # the rest score below 0 (affinity -0.5)
    full = zero.copy()
    z_rows = [1, n - 1, n + 3, N - 1]
    full[z_rows, :2] = cap[z_rows, :2] - d[:2]
    aff = np.full(N, -0.5, np.float32)
    aff[z_rows] = 0.0
    pen = np.zeros(N, bool)
    pen[z_rows] = True
    zero_ev = lambda c: ev(c, affinity=aff, has_affinity=True,  # noqa: E731
                           penalty=pen)
    cases.append(("scores of exactly 0.0 at the top", cap, full,
                  _select_lanes(N, [[zero_ev(6 + w), zero_ev(3), ev(0)]
                                    for w in range(W)]), False))

    # deltas of non-integer sizes: an eval's back-out `used - (used -
    # used_in)` rounds, also on count-0 pads
    used = (rng.integers(0, 6, (N, 4)) * d).astype(np.float32)
    used[:, :2] += rng.random((N, 2), dtype=np.float32) * 37.5

    def deltas(k):
        rows = rng.choice(N, k, replace=False)
        return [(int(r), np.array([rng.random() * 90 - 45,
                                   rng.random() * 200 - 100, 0, 0],
                                  np.float32)) for r in rows]
    pads = [[ev(3, deltas=deltas(4)), ev(0, deltas=deltas(5)), ev(4)]]
    pads += [[ev(0, deltas=deltas(3)), ev(5, deltas=deltas(2)),
              ev(0, deltas=deltas(6))]]
    pads += [[ev(0), ev(0, deltas=deltas(2)), ev(0)]] * (W - 2)
    cases.append(("lane pads of count 0 with deltas", cap, used,
                  _select_lanes(N, pads[:W]), False))

    # one row's deltas in an order whose float sums round otherwise than
    # any other order; rows on two shards
    r0, r1 = n - 1, n + 4
    rep = [(r0, np.array([1e7, 0.3, 0, 0], np.float32)),
           (r1, np.array([0.1, 0.7, 0, 0], np.float32)),
           (r0, np.array([0.3, 1e7, 0, 0], np.float32)),
           (r0, np.array([-1e7, 0.4, 0, 0], np.float32)),
           (r1, np.array([0.2, -0.3, 0, 0], np.float32)),
           (r0, np.array([0.2, -1e7, 0, 0], np.float32))]
    cases.append(("delta rows that repeat a row", cap, used,
                  _select_lanes(N, [[ev(4, deltas=rep), ev(6, deltas=rep[::-1]),
                                     ev(0, deltas=rep)]] * W), False))

    # a usage row at +inf, deltas on it and on others: its delta is NaN,
    # and the eval's back-out leaves NaN in its carry
    inf_used = used.copy()
    inf_used[[1, n + 1], 0] = np.inf
    ds = [(1, np.array([100, 0, 0, 0], np.float32)),
          (n + 2, np.array([-50, 256, 0, 0], np.float32)),
          (n + 1, np.array([0, -256, 0, 0], np.float32))]
    cases.append(("a usage row at +inf under deltas", cap, inf_used,
                  _select_lanes(N, [[ev(5 + w, deltas=ds), ev(3, deltas=ds),
                                     ev(0, deltas=ds)] for w in range(W)]),
                  False))

    # fitting rows that score NaN: +inf capacity and usage (1 - inf / inf;
    # -NaN on the CPU, +NaN on the card).  Spread, so that a strict wave
    # (some m = 1 score above every m = 2 score) keeps placing wherever
    # the NaN ranks in the top-2
    nan_used = (rng.integers(0, 4, (N, 4)) * d).astype(np.float32)
    nan_cap, r_nan = cap.copy(), n + 5
    nan_cap[r_nan, 0] = nan_used[r_nan, 0] = np.inf
    cases.append(("a fitting row scoring NaN at m = 1", nan_cap, nan_used,
                  _select_lanes(N, [[ev(6 + w), ev(3), ev(0)]
                                    for w in range(W)]), True))

    # cpu in units of 1e38: the row at +inf capacity and 2e38 usage fits
    # m = 1 at a finite score and m = 2 at NaN (4e38 rounds to +inf), so
    # its shard's m = 2 maximum is NaN; after it takes one instance its
    # m = 1 score is NaN too
    big_d = np.asarray((1e38, 256.0, 0.0, 0.0), np.float32)
    big_cap = cap.copy()
    big_cap[:, 0] = np.finfo(np.float32).max
    big_used = np.zeros((N, 4), np.float32)
    big_used[:, 0] = rng.choice(np.float32([0.0, 0.5e38, 1e38]), N)
    r_m2 = n + 2
    big_cap[r_m2, 0], big_used[r_m2, 0] = np.inf, 2e38
    cases.append(("a fitting row scoring NaN at m = 2 only", big_cap,
                  big_used,
                  _select_lanes(N, [[ev(5 + w, demand=big_d),
                                     ev(2, demand=big_d), ev(0)]
                                    for w in range(W)]), True))

    # a NaN row on shard 1 between finite rows on the shards before and
    # after it: the best score on shard 0, the second on the last shard,
    # the NaN shard's own rows below both
    mid_used = np.tile(3 * d, (N, 1)).astype(np.float32)
    mid_cap = cap.copy()
    mid_used[4] = 0.0
    mid_used[N - 2] = d / 2
    mid_used[n + 1] = d
    mid_cap[n + 3, 0] = mid_used[n + 3, 0] = np.inf
    cases.append(("a NaN row on one shard between finite scores on the "
                  "others", mid_cap, mid_used,
                  _select_lanes(N, [[ev(4 + w), ev(9), ev(0)]
                                    for w in range(W)]), True))

    # an affinity of -inf on every row: every fitting row scores -inf at
    # every m, so the top score and s* are -inf and the wave is the tie
    # set of the fitting rows (the reference takes `fits` itself), one
    # instance a row in row order; rows that do not fit (usage at
    # capacity) lie before, between and after them, on both sides of a
    # shard boundary, and score -inf too
    ninf_used = (rng.integers(0, 4, (N, 4)) * d).astype(np.float32)
    full_rows = [0, 1, 3, n - 1, n, N - 2]
    ninf_used[full_rows] = cap[full_rows]
    ninf = np.full(N, -np.inf, np.float32)
    ninf_ev = lambda c: ev(c, affinity=ninf, has_affinity=True)  # noqa: E731
    cases.append(("every fitting row scoring -inf (an affinity of -inf)",
                  cap, ninf_used,
                  _select_lanes(N, [[ninf_ev(5 + w), ninf_ev(n + 3), ev(0)]
                                    for w in range(W)]), False))
    return cases


# ------------------------------------------------- K7a's scan cache cases

SCAN_EVALS = 2                      # evals of every scan case's chain
SCAN_SLOTS = 12                     # slots an eval
SCAN_DELTAS = 8                     # delta slots an eval
_SCAN_G, _SCAN_K, _SCAN_V = 3, 2, 6
_SCAN_DEMAND = (300.0, 512.0, 0.0, 0.0)


def _scan_world(rng, N: int, uniform: bool = False):
    """Capacity and usage of N rows (integer sizes); `uniform`: every row
    the same and empty."""
    cap = np.zeros((N, 4), np.float32)
    cap[:] = (4000.0, 8192.0, 100000.0, 1000.0)
    used = np.zeros((N, 4), np.float32)
    if not uniform:
        cap[:, 0] = rng.choice([2000, 4000, 8000], N)
        cap[:, 1] = rng.choice([4096, 8192, 16384], N)
        used[:, 0] = rng.integers(0, 8, N) * 100
        used[:, 1] = rng.integers(0, 8, N) * 256
    return cap, used


def _scan_eval(rng, N: int, v: int = _SCAN_V) -> dict:
    """One eval's fields (numpy; every scoring feature on, an even and a
    targeted spread over v values): every slot active, of group 0, at
    _SCAN_DEMAND."""
    G, K, S = _SCAN_G, _SCAN_K, SCAN_SLOTS
    desired = np.full((G, K, v + 1), -1.0, np.float32)
    desired[:, 1, :v] = rng.integers(0, 6, (G, v))
    targeted = np.zeros((G, K), bool)
    targeted[:, 1] = True
    counts = np.zeros((G, K, v + 1), np.float32)
    counts[..., :v] = rng.integers(0, 3, (G, K, v))
    return dict(
        feasible=rng.random((G, N)) < 0.9,
        affinity=rng.choice(np.array([-1.0, -0.5, 0.0, 0.0, 0.5, 1.0],
                                     np.float32), (G, N)),
        has_affinity=np.array([True, False, True]),
        desired_count=rng.integers(1, 20, G).astype(np.int32),
        penalty=rng.random((G, N)) < 0.05,
        tg_count=(rng.random((G, N)) < 0.1).astype(np.int32),
        spread_vidx=rng.integers(0, v + 1, (G, K, N)).astype(np.int32),
        spread_desired=desired, spread_targeted=targeted,
        spread_wfrac=rng.choice(np.array([0.25, 0.5, 1.0], np.float32),
                                (G, K)),
        spread_counts=counts, spread_active=np.ones((G, K), bool),
        place_cap=np.where(rng.random((G, N)) < 0.2,
                           rng.integers(0, 3, (G, N)), -1).astype(np.int32),
        demand=np.tile(np.asarray(_SCAN_DEMAND, np.float32), (S, 1)),
        slot_tg=np.zeros(S, np.int32), slot_active=np.ones(S, bool))


def _scan_chain(N: int, evals, deltas=None):
    """place_batch_sharded's stacked fields and delta operands: eval e's
    deltas deltas[e] = [(row, f32[4])] (pad rows N)."""
    E = len(evals)
    fields = {k: np.stack([ev[k] for ev in evals]) for k in evals[0]}
    drows = np.full((E, SCAN_DELTAS), N, np.int32)
    dvals = np.zeros((E, SCAN_DELTAS, 4), np.float32)
    for e, ds in enumerate(deltas or []):
        for d, (r, val) in enumerate(ds):
            drows[e, d] = r
            dvals[e, d] = val
    return fields, drows, dvals


def scan_cache_cases(n_rows: int, node_shards: int, seed: int = 0) -> list:
    """The cases of K7a's cached step as `place_batch_sharded` operands on
    `node_shards` node shards: [(label, capacity f32[N, 4], used f32[N,
    4], fields {name: [E, ...] numpy}, delta_rows i32[E, D], delta_vals
    f32[E, D, 4], spread_algorithm)], SCAN_EVALS evals of SCAN_SLOTS
    slots, SCAN_DELTAS delta slots an eval.  n_rows a multiple of
    node_shards, at least 16 rows a shard.  The cases: the group changing
    between slots; the demand changing within a group (also only in the
    sign of a zero); inactive slots between active ones (and at an eval's
    first slot); a pick on each shard and on the rows either side of a
    shard boundary; every row infeasible; rows that tie across shards;
    -0.0 usage; NaN and +-inf usage under deltas; a spread over more than
    64 values; spreads whose boost tables pass K7a's shared memory."""
    rng = np.random.default_rng(seed)
    N, NS = n_rows, node_shards
    n = N // NS
    assert n * NS == N and n >= 16
    cases = []

    def add(label, evals, world=None, deltas=None, spread=False):
        cap, used = world if world is not None else _scan_world(rng, N)
        cases.append((label, cap, used) + _scan_chain(N, evals, deltas)
                     + (spread,))

    def deltas(k):
        rows = rng.choice(N, k, replace=False)
        return [(int(r), np.array([rng.integers(-2, 3) * 100,
                                   rng.integers(-2, 3) * 256, 0, 0],
                                  np.float32)) for r in rows]

    # the group changes between slots: each group its own demand
    evals = []
    for _ in range(SCAN_EVALS):
        ev = _scan_eval(rng, N)
        ev["slot_tg"][:] = [0, 0, 1, 1, 0, 2, 2, 2, 1, 0, 0, 1]
        ev["demand"][:, :2] = [(100.0 * (g + 2), 256.0 * (g + 1))
                               for g in ev["slot_tg"]]
        evals.append(ev)
    add("group changes between slots", evals, deltas=[[], deltas(4)])

    # the demand changes within group 0: a, a, b, b, a, c, c, a, ... where
    # c is a but for the sign of a zero
    evals = []
    dem = {"a": (300.0, 512.0, 0.0, 0.0), "b": (200.0, 1024.0, 0.0, 0.0),
           "c": (300.0, 512.0, -0.0, 0.0)}
    for pattern in ("aabbaccabaaa", "cabbbacaabcc"):
        ev = _scan_eval(rng, N)
        ev["demand"][:] = [dem[x] for x in pattern]
        evals.append(ev)
    add("demand changes within a group", evals, spread=True)

    # inactive slots between active ones; the second eval starts with one
    evals = []
    for pattern in ("110100110110", "011011101101"):
        ev = _scan_eval(rng, N)
        ev["slot_active"][:] = [x == "1" for x in pattern]
        evals.append(ev)
    add("inactive slots between active ones", evals, deltas=[deltas(3), []])

    # one row on each shard and the two rows either side of the boundary
    # of shards 0 and 1 win once each (affinity, a budget of one), in
    # row order, on a uniform world; then the rest
    world = _scan_world(rng, N, uniform=True)
    wins = sorted({n - 1, n} | {i * n + 5 for i in range(NS)})
    evals = []
    for _ in range(SCAN_EVALS):
        ev = _scan_eval(rng, N)
        ev["feasible"][:] = True
        ev["affinity"][:] = 0.0
        ev["affinity"][0, wins] = 1.0
        ev["has_affinity"][:] = True
        ev["penalty"][:] = False
        ev["tg_count"][:] = 0
        ev["place_cap"][:] = -1
        ev["place_cap"][0, wins] = 1
        ev["spread_active"][0] = False
        evals.append(ev)
    add("a pick on each shard and on a shard boundary row", evals, world)

    # group 1 has no feasible row; the second eval asks only for it
    evals = []
    for tgs in ([1, 1, 0, 1, 0, 0, 1, 2, 1, 0, 1, 1], [1] * SCAN_SLOTS):
        ev = _scan_eval(rng, N)
        ev["feasible"][1] = False
        ev["slot_tg"][:] = tgs
        evals.append(ev)
    add("every row infeasible", evals)

    # a uniform world, no affinity, penalty or co-placement, one even
    # spread whose values repeat every 6 rows: the rows tie across shards
    evals = []
    for _ in range(SCAN_EVALS):
        ev = _scan_eval(rng, N)
        ev["feasible"][:] = True
        ev["affinity"][:] = 0.0
        ev["penalty"][:] = False
        ev["tg_count"][:] = 0
        ev["place_cap"][:] = -1
        ev["spread_active"][:, 1] = False
        ev["spread_vidx"][:, 0] = np.arange(N) % _SCAN_V
        ev["spread_counts"][:] = 0.0
        evals.append(ev)
    add("rows that tie across shards", evals,
        _scan_world(rng, N, uniform=True))

    # -0.0 usage: every row's disk and network, a third of the cpu; deltas
    # of -0.0 onto such rows
    cap, used = _scan_world(rng, N)
    used[:, 2:] = -0.0
    used[::3, 0] = -0.0
    neg = [(3 * k, np.array([-0.0, 0.0, -0.0, -0.0], np.float32))
           for k in (1, 5, 9)]
    add("-0.0 usage", [_scan_eval(rng, N) for _ in range(SCAN_EVALS)],
        (cap, used), deltas=[neg, neg[:1]])

    # usage at +inf and -inf, deltas that take a +inf row to NaN, keep
    # others infinite, or are NaN themselves
    cap, used = _scan_world(rng, N)
    used[[1, n + 1], 0] = np.inf
    used[[2, N - 2], 1] = -np.inf
    inf_d = [(1, np.array([-np.inf, 0, 0, 0], np.float32)),
             (n + 1, np.array([100, 0, 0, 0], np.float32)),
             (N - 2, np.array([0, 512, 0, 0], np.float32)),
             (4, np.array([np.nan, 0, 0, 0], np.float32)),
             (n + 3, np.array([np.inf, 0, 0, 0], np.float32))]
    add("NaN and +-inf usage under deltas",
        [_scan_eval(rng, N) for _ in range(SCAN_EVALS)], (cap, used),
        deltas=[inf_d, inf_d[2:]])

    # a spread over 80 values (V1 = 81): its table past 64 entries
    add("a spread over more than 64 values",
        [_scan_eval(rng, N, v=80) for _ in range(SCAN_EVALS)], spread=True)

    # two spreads over 8,200 values: K x V1 past the 16,384 table floats a
    # block of K7a keeps in shared memory (its tables in the cache)
    add("tables past shared memory",
        [_scan_eval(rng, N, v=8200) for _ in range(SCAN_EVALS)])
    return cases


# ---------------------------------------------------- K7d's run cases

def bulk_run_cases(n_rows: int, seed: int = 0) -> list:
    """The cases of K7d's first-failure rule, one eval's first wave over
    n_rows rows (at least 32): [(label, capacity f32[N, 4], used f32[N,
    4], eval {feasible, affinity, penalty, coll0: [N]; has_affinity,
    desired, count; demand f32[4]}, fill_grid, spread_algorithm, placed,
    done)], `placed` the lane state's count before the wave, `done` its
    flag.  The cases: a run cap of 1; fill grids of 16 and 64; m = 1
    forced where the score does not beat `second`; rows that fit one
    instance and not two; no row fitting; the tie set; the strict set; a
    done lane; NaN and +-inf usage."""
    rng = np.random.default_rng(seed)
    N = n_rows
    dem = np.asarray(_SELECT_DEMAND, np.float32)
    cap = np.tile(np.asarray(_SELECT_CAP, np.float32), (N, 1))
    uniform = np.zeros((N, 4), np.float32)
    mixed = (rng.integers(0, 6, (N, 4)) * dem).astype(np.float32)
    mixed[:, :2] += rng.integers(0, 4, (N, 2)) * 100.0

    def ev(count, **kw):
        e = dict(feasible=rng.random(N) < 0.9,
                 affinity=rng.choice(np.array([-0.5, 0.0, 0.0, 0.5],
                                              np.float32), N),
                 penalty=rng.random(N) < 0.05,
                 coll0=(rng.random(N) < 0.1).astype(np.int32),
                 has_affinity=True, desired=max(count, 1), demand=dem,
                 count=count)
        e.update(kw)
        return e

    one_more = mixed.copy()
    tight = rng.choice(N, N // 4, replace=False)
    one_more[tight, :2] = cap[tight, :2] - 1.5 * dem[:2]
    odd = mixed.copy()
    odd[1, 0] = np.inf
    odd[5, 1] = -np.inf
    odd[9, 0] = np.nan
    odd[N // 2 + 2, 0] = -np.inf
    plain = dict(affinity=np.zeros(N, np.float32), penalty=np.zeros(N, bool),
                 coll0=np.zeros(N, np.int32), feasible=np.ones(N, bool))
    # one co-placement already, so the anti-affinity term counts from
    # m = 1 and no row's first score beats the best second one: the tie
    # set; with room for 40 or 50 instances a row its binpack scores rise
    # with m and its runs end at the rows' room, past 32
    big = cap.copy()
    big[:, 0] = rng.choice([40, 50], N) * dem[0]
    big[:, 1] = 1e6
    roomy = dict(plain, coll0=np.ones(N, np.int32))
    return [
        ("run cap 1", cap, mixed, ev(1), 16, False, 0, False),
        ("fill grid 16", cap, mixed, ev(100), 16, False, 0, False),
        ("fill grid 64", big, uniform, ev(300, **roomy), 64, False, 40,
         False),
        ("m = 1 forced where the score does not beat second", cap, uniform,
         ev(50, **plain), 16, True, 0, False),
        ("rows that fit one instance and not two", cap, one_more, ev(20),
         16, False, 0, False),
        ("no row fitting", cap, mixed, ev(20, feasible=np.zeros(N, bool)),
         16, False, 0, False),
        ("the tie set", cap, uniform, ev(30, **roomy), 16, False, 0, False),
        ("the strict set", cap, mixed, ev(30), 16, True, 0, False),
        ("a done lane", cap, mixed, ev(20), 16, False, 0, True),
        ("NaN and +-inf usage", cap, odd, ev(20), 16, False, 0, False),
    ]


def bulk_run_shards(case, node_shards: int, dev="cpu"):
    """A K7d case's wave on `node_shards` shards: ([BulkShard], stats
    f32[NS, 4], cur_g f32[N]) after each shard's K7c begin (the plain
    version; the lane state's placed count and done flag then set as the
    case says), the operands of K7d on each shard."""
    import torch
    from nomad_tpu_torch.ops import sharded as k7
    _, cap, used, ev, _, spread, placed, done = case
    N, NS = cap.shape[0], node_shards
    n = N // NS
    t = lambda x, dt=None: torch.as_tensor(np.array(x), dtype=dt,  # noqa
                                           device=dev)
    stats = torch.zeros((NS, k7.STATS_W), dtype=torch.float32, device=dev)
    cur_g = torch.zeros(N, dtype=torch.float32, device=dev)
    shards = []
    for i in range(NS):
        sl = slice(i * n, (i + 1) * n)
        z = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
            s, dtype=dt, device=dev)
        sh = k7.BulkShard(
            off=i * n, n_rows=N, capacity=t(cap[sl]), used=t(used[sl]),
            exact=t(used[sl]), delta=z(n, 4), coll=z(n, dt=torch.int32),
            feasible=t(ev["feasible"][None, sl]),
            affinity=t(ev["affinity"][None, sl]),
            penalty=t(ev["penalty"][None, sl]),
            coll0=t(ev["coll0"][None, sl], torch.int32),
            has_affinity=t([ev["has_affinity"]]),
            desired=t([ev["desired"]], torch.int32),
            demand=t(ev["demand"][None]),
            count=t([ev["count"]], torch.int32), delta_rows=None,
            delta_vals=None, assign=z(1, n, dt=torch.int32),
            scores=z(1, n), partial=z(1, k7.COUNTS_W, dt=torch.int32),
            state=z(k7.STATE_W, dt=torch.int32)).check()
        k7.bulk_stats_plain(sh, 0, True, stats, cur_g, i, spread, 1000)
        sh.state[k7.ST_PLACED] = placed
        sh.state[k7.ST_DONE] = int(done)
        shards.append(sh)
    return shards, stats, cur_g


# ------------------------------------------------------ K7b's merge cases

APPLY_GROUPS = 2                    # groups of every K7b case
APPLY_SLOTS = 4                     # slots; slot s of the case's t-th call
_APPLY_SLOT_TG = (0, 1, 1, 0)       # is t % APPLY_SLOTS


def _apply_records(rng, NS, n, K, V1, bests, rows=None, pool=None,
                   tops=None):
    """One slot's gathered K7b records i32[NS, SCAN_REC] in K7a's layout:
    shard j's best bests[j] at global row rows[j] (default a row of its
    own), its top list led by that entry and followed by entries of
    `pool` no higher (or the first min(5, n) scores of tops[j]), the
    list's other rows distinct rows of the shard, entries past the list
    -inf with row 2**31 - 1; a random fit score, n_eval, n_exh and K
    spread value indices in [0, V1) (V1 - 1: the missing attribute)."""
    from nomad_tpu_torch.ops import sharded as k7
    kloc = min(k7.TOP_K, n)
    pool = np.asarray(pool if pool is not None else (0.5, 0.25, -1.0,
                                                     -np.inf), np.float32)
    recs = np.zeros((NS, k7.SCAN_REC), np.int32)
    recf = recs.view(np.float32)
    for j in range(NS):
        local = rng.permutation(n)
        b = np.float32(bests[j])
        row = int(rows[j]) if rows is not None else j * n + int(local[0])
        if tops is not None:
            ts = np.asarray(tops[j][:kloc], np.float32)
        else:
            low = pool if np.isnan(b) else pool[~(pool > b)]
            ts = np.concatenate([[b], -np.sort(-rng.choice(
                low if low.size else np.float32([-np.inf]), kloc - 1))])
        recf[j, k7.REC_BEST] = b
        recs[j, k7.REC_ROW] = row
        recf[j, k7.REC_FIT] = np.float32(rng.random() * 18)
        recs[j, k7.REC_NEVAL] = rng.integers(0, n + 1)
        recs[j, k7.REC_NEXH] = rng.integers(0, n + 1)
        recf[j, k7.REC_TOPS:k7.REC_TOPS + k7.TOP_K] = -np.inf
        recf[j, k7.REC_TOPS:k7.REC_TOPS + kloc] = ts
        recs[j, k7.REC_TOPI:k7.REC_TOPI + k7.TOP_K] = 2 ** 31 - 1
        recs[j, k7.REC_TOPI] = row
        recs[j, k7.REC_TOPI + 1:k7.REC_TOPI + kloc] = j * n + local[1:kloc]
        recs[j, k7.REC_V:k7.REC_V + K] = rng.integers(0, V1, K)
    return recs


def scan_apply_cases(node_shards: int, seed: int = 0) -> list:
    """K7b's cases on `node_shards` shards (1 to 8): [dict(label, n, K,
    V1, used f32[N, 4], tg_count i32[G, N], place_cap i32[G, N], counts
    f32[G, K, V1], active bool[G, K], demand f32[S, 4], slot_tg i32[S],
    records [i32[NS, SCAN_REC]] one a call)], a call t on slot t % S.
    The carries: non-integer usage with -0.0 cells, co-placement counts,
    place caps of -1 to 2, spread counts.  The cases: equal bests on
    several shards (also with the rows out of shard order, so the lowest
    row is a later shard's); +0.0 and -0.0 bests and top entries (every
    shard's best a zero; and beside lower bests); shards of fewer than 5
    rows; fewer than 5 fitting rows (-inf tails); every row infeasible;
    K = 1 and K = 64; inactive spreads and the V1 - 1 sentinel; a pick on
    each shard and on the rows either side of a shard boundary; a NaN
    best; NaN top entries (below every score in the merge)."""
    rng = np.random.default_rng(seed + 1000 * node_shards)
    NS, G, S = node_shards, APPLY_GROUPS, APPLY_SLOTS
    cases = []

    def add(label, n, K, V1, calls, active=None):
        N = NS * n
        used = (rng.integers(0, 8, (N, 4)) * 100
                + rng.random((N, 4)) * 10).astype(np.float32)
        used[rng.random((N, 4)) < 0.2] = -0.0
        demand = np.tile(np.float32([33.3, 70.7, 0.1, 0.0]), (S, 1))
        demand[1, 2] = -0.0
        if active is None:
            active = rng.random((G, K)) < 0.7
        counts = rng.integers(0, 4, (G, K, V1)).astype(np.float32)
        cases.append(dict(
            label=label, n=n, K=K, V1=V1, used=used,
            tg_count=rng.integers(0, 3, (G, N)).astype(np.int32),
            place_cap=rng.choice(np.int32([-1, 0, 1, 2]), (G, N)),
            counts=(counts + (rng.random(counts.shape) < 0.1)
                    * np.float32(0.5)).astype(np.float32),
            active=np.asarray(active, bool), demand=demand,
            slot_tg=np.int32(_APPLY_SLOT_TG),
            records=[c(n, K, V1) for c in calls]))

    def recs(bests, **kw):
        return lambda n, K, V1: _apply_records(rng, NS, n, K, V1, bests,
                                               **kw)

    def some(values):
        return rng.choice(np.float32(values), NS)

    ties = (0.75, 0.5, 0.25, -np.inf)
    calls = []
    for _ in range(S):
        b = some((0.75, 0.5, -np.inf))
        b[rng.choice(NS, min(2, NS), replace=False)] = 0.75
        calls.append(recs(b, pool=ties))
    add("equal bests on several shards", 8, 3, 6, calls)
    add("equal bests, rows out of shard order", 8, 3, 6,
        [recs(np.full(NS, 0.75, np.float32),
              rows=[(NS - 1 - j) * 8 + 3 + t for j in range(NS)],
              pool=ties) for t in range(S)])
    zeros = (0.0, -0.0, -0.5, -np.inf)
    add("+0.0 and -0.0 bests and top entries", 8, 3, 6,
        [recs(some((0.0, -0.0)), pool=zeros) for _ in range(S)])
    calls = [recs(some((0.0, -0.0, -0.5, -np.inf)), pool=zeros)
             for _ in range(2 * S)]
    if NS > 2:
        # +0.0 on shard 1, -0.0 on shard 2, lower bests elsewhere
        b = np.full(NS, -1.0, np.float32)
        b[1], b[2] = 0.0, -0.0
        calls.append(recs(b, pool=zeros))
    add("+0.0 and -0.0 bests beside lower ones", 8, 3, 6, calls)
    few = {1: 5, 2: 3, 4: 2, 8: 1}[NS]
    add(f"shards of few rows (n = {few})", few, 3, 6,
        [recs(some((0.5, 0.25, -np.inf)), pool=(0.25, -np.inf))
         for _ in range(S)])
    calls = []
    for _ in range(S):
        fit = rng.integers(0, 4, NS)
        tops = [[0.5] * k + [-np.inf] * (5 - k) for k in fit]
        calls.append(recs(np.float32([t[0] for t in tops]), tops=tops))
    add("fewer than 5 fitting rows", 8, 3, 6, calls)
    add("every row infeasible", 8, 3, 6,
        [recs(np.full(NS, -np.inf, np.float32)) for _ in range(S)])
    add("K = 1", 8, 1, 4, [recs(some((0.5, 0.25))) for _ in range(S)])
    add("K = 64", 8, 64, 5, [recs(some((0.5, 0.25))) for _ in range(S)])
    add("inactive spreads and the V1 - 1 sentinel", 8, 4, 6,
        [recs(some((0.5, 0.25))) for _ in range(2 * S)],
        active=[[True, False, True, False], [False, True, True, True]])
    n = 8
    wins = [j * n + 5 for j in range(NS)] + [0, NS * n - 1] + (
        [n - 1, n] if NS > 1 else [])
    calls = []
    for w in wins:
        b = np.full(NS, 0.5, np.float32)
        rows = [j * n + (1 if w != j * n + 1 else 2) for j in range(NS)]
        b[w // n], rows[w // n] = 0.9, w
        calls.append(recs(b, rows=rows))
    add("a pick on each shard and either side of a shard boundary", n, 3,
        6, calls)
    calls = []
    for t in range(S):
        b = some((0.5, 0.25))
        b[t % NS] = np.nan
        calls.append(recs(b))
    add("a NaN best", 8, 3, 6, calls)
    calls = []
    for _ in range(S):
        b = some((0.5, 0.25, -np.inf))
        calls.append(recs(b, tops=[[b[j]] * (1 - j % 2) + [np.nan] * 5
                                   for j in range(NS)]))
    add("NaN top entries", 8, 3, 6, calls)
    return cases


def scan_apply_shards(case: dict, dev="cpu"):
    """A K7b case's NS ScanShards (the carries from the case, the other
    fields placeholders K7b does not read), its records as tensors and
    the packed rows' output f32[S, 5 + 2 * TOP_K]."""
    import torch
    from nomad_tpu_torch.ops import sharded as k7
    n, K, V1 = case["n"], case["K"], case["V1"]
    N = case["used"].shape[0]
    NS, G, S = N // n, APPLY_GROUPS, APPLY_SLOTS
    t = lambda x, dt=None: torch.as_tensor(np.array(x), dtype=dt,  # noqa
                                           device=dev)
    z = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
        s, dtype=dt, device=dev)
    shards = []
    for i in range(NS):
        sl = slice(i * n, (i + 1) * n)
        shards.append(k7.ScanShard(
            off=i * n, capacity=z(n, 4), used=t(case["used"][sl]),
            feasible=z(G, n, dt=torch.bool), affinity=z(G, n),
            penalty=z(G, n, dt=torch.bool), tg0=z(G, n, dt=torch.int32),
            cap0=z(G, n, dt=torch.int32), vidx=z(G, K, n, dt=torch.int32),
            has_affinity=z(G, dt=torch.bool),
            desired_count=z(G, dt=torch.int32), spread_desired=z(G, K, V1),
            spread_targeted=z(G, K, dt=torch.bool), spread_wfrac=z(G, K),
            counts0=z(G, K, V1), spread_active=t(case["active"]),
            demand=t(case["demand"]), slot_tg=t(case["slot_tg"]),
            slot_active=torch.ones(S, dtype=torch.bool, device=dev),
            tg_count=t(case["tg_count"][:, sl]),
            place_cap=t(case["place_cap"][:, sl]),
            counts=t(case["counts"]), cache=k7.scan_cache(n, K, V1, dev),
            pick=z(1, dt=torch.int32)).check())
    recs = [t(r) for r in case["records"]]
    out = torch.full((S, 5 + 2 * k7.TOP_K), -7.0, device=dev)
    return shards, recs, out
