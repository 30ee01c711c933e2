"""K7e's selection cases as `place_bulk_batch_sharded` operands: the
inputs of tests/test_torch_sharded_select.py and of chip_smoke.py's
sharded phase, built with numpy from one seed."""
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
    order that rounds differently); a usage row at +inf under deltas."""
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
    return cases
