"""B15's keyed selection (``keyed_topk`` of ``csrc/scattered_select.cu``)
written out in Python against the selection it stands for (``exact_topk``,
idw_query's tournament: k passes of the lowest (d2 bits, tap) minimum,
stopping at the first not below 1.5e30).

The keyed passes order the taps by ((d2 bits >> (B - 1)) << B) | tap, B
the bits of a tap index (5 up to 32 taps, 6 up to 64), one unsigned
tournament of key - thr a pass; the kernel trusts their first k slots only
where no two consecutive slots share d2 bits >> (B - 1) but not d2, and the
k-th and the (k + 1)-th winners do not share them, and else runs the
tournament.  Here, on the radius-2 and radius-3 windows' taps at random,
node, half-node and line queries with random validity, and on d2 rows with
exact ties and planted near-ties (d2 a few ulp apart), every slot list the
keyed passes vouch for equals the tournament's, and the near-ties are
refused.  The
kernel is held to ``window_idw_ref`` bit for bit on a card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from auvtpu_torch.ops.packs import window_offsets

K_INF = np.float32(3e30)
HALF_INF = np.float32(1.5e30)
HALF_SENTINEL = np.float32(0.5e30)


def _bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def exact_topk(d2, k):
    """idw_query's passes: the lowest (d2 bits as int32, tap) minimum, each
    winner knocked out, stopping at the first not below 1.5e30."""
    d2 = np.array(d2, np.float32)
    signed = d2.view(np.int32).astype(np.int64)
    taken = np.zeros(len(d2), bool)
    slots = []
    for _ in range(k):
        keys = np.where(taken, np.int64(_bits(K_INF)), signed)
        t = int(np.argmin(keys))  # the lowest index of the minimum
        m = np.int32(keys[t]).view(np.float32)
        if not m < HALF_INF:
            break
        slots.append((t, _bits(m)))
        taken[t] = True
    return slots


def keyed_topk(d2, k):
    """keyed_topk: the slots (tap, d2 bits), or None where the kernel runs
    the tournament instead."""
    d2 = np.array(d2, np.float32)
    B = 5 if len(d2) <= 32 else 6
    key = [((_bits(v) >> (B - 1)) << B) | t for t, v in enumerate(d2)]
    wk, thr = [], 0
    for _ in range(k + 1):
        w = min((x - thr) % 2**32 for x in key) + thr
        wk.append(w % 2**32)
        thr = (w + 1) % 2**32
    found, exact, slots = 0, True, []
    for s in range(k):
        t = wk[s] & ((1 << B) - 1)
        m = d2[t]
        found += found == s and m < HALF_INF
        if 0 < s < found:
            exact = exact and ((wk[s - 1] >> B) != (wk[s] >> B) or slots[-1][1] == _bits(m))
        slots.append((t, _bits(m)))
    exact = exact and (found < k or (wk[k - 1] >> B) != (wk[k] >> B))
    return slots[:found] if exact else None


def _window_d2(fx, fy, valid, half=0.0, radius=2):
    """A window's d2 as the kernel computes it (f32, -fmad=false: each op
    rounded), 3e30 at an invalid tap."""
    offs = np.asarray(window_offsets(radius), np.float32)  # (M, 2): each tap's dx, dy
    di = (offs[:, 0] + np.float32(half)) - np.float32(fx)
    dj = (offs[:, 1] + np.float32(half)) - np.float32(fy)
    d2 = (di * di).astype(np.float32) + (dj * dj).astype(np.float32)
    return np.where(valid, d2, K_INF).astype(np.float32)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("kind", ["random", "nodes_and_lines", "sparse", "random_r3", "nodes_and_lines_r3"])
def test_keyed_slots_equal_the_tournament_on_window_queries(kind, k):
    radius = 3 if kind.endswith("_r3") else 2
    kind = kind.removesuffix("_r3")
    rng = np.random.default_rng(len(kind) * 10 + k + radius)
    M = len(window_offsets(radius))
    vouched = refused = 0
    for _ in range(3000):
        if kind == "nodes_and_lines":
            fx = rng.choice([0.0, 0.5, -0.5, 0.25, rng.uniform(-0.5, 0.5)])
            fy = rng.choice([0.0, 0.5, -0.5, fx, -fx, rng.uniform(-0.5, 0.5)])
        else:
            fx, fy = rng.uniform(-0.5, 0.5, 2)
        valid = rng.random(M) < (0.15 if kind == "sparse" else 0.9)
        d2 = _window_d2(fx, fy, valid, half=rng.choice([0.0, 0.5]), radius=radius)
        got, want = keyed_topk(d2, k), exact_topk(d2, k)
        if got is None:
            refused += 1
        else:
            vouched += 1
            assert got == want, (fx, fy, valid)
    # the tournament runs only where the keys cannot vouch: never here on
    # random queries; on nodes and lines the exact ties are vouched for where
    # no two of them straddle the last slot
    assert vouched > 0 and (kind == "nodes_and_lines" or refused == 0), (vouched, refused)


@pytest.mark.parametrize("M", [25, 49])
@pytest.mark.parametrize("k", [4, 8])
def test_keyed_passes_refuse_near_ties_and_keep_exact_ties(k, M):
    rng = np.random.default_rng(k + M)
    B = 5 if M <= 32 else 6
    refused = {0: 0, 1: 0}
    for trial in range(2000):
        base = rng.uniform(0.05, 32.0, M).astype(np.float32)
        # plant a near-tie (fewer ulp apart than 2 ** (B - 1), so d2 bits >>
        # (B - 1) may agree) or an exact tie among the smallest taps, some
        # taps invalid
        order = np.argsort(base)
        a, b = (int(t) for t in rng.choice(order[:k + 1], 2, replace=False))
        ulps = 0 if trial % 3 == 0 else int(rng.integers(1, 2**(B - 1)))
        base[b] = np.uint32(_bits(base[a]) + ulps).view(np.float32)
        base[rng.random(M) < 0.1] = K_INF
        got, want = keyed_topk(base, k), exact_topk(base, k)
        assert got is None or got == want, (trial, a, b, ulps)
        refused[ulps > 0] += got is None
        if got is not None and ulps:
            # vouched for despite the near-tie: the two share no d2 bits >>
            # (B - 1) or are not both among the first k + 1
            ra, rb = (_bits(base[t]) >> (B - 1) for t in (a, b))
            assert ra != rb or not {a, b} <= {t for t, _ in exact_topk(base, k + 1)}
    assert refused[1] > 100, refused  # the near-ties that share d2 bits >> (B - 1) go to the tournament
