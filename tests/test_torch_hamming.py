"""Parity of the port's Hamming matching (``bundle_adjustment_tpu_torch.ops.
hamming`` and the K1 wrapper ``ops.hamming_kernel``) with the JAX package.

Inputs are made with numpy and handed to both sides.  Every comparison is
exact: distances are integers <= 256 (or the INVALID_DIST sentinel) in both
implementations, and both take the first index on ties.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.ops import hamming as jham
from bundle_adjustment_tpu.ops.hamming_pallas import knn2_pallas
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.ops import hamming as tham
from bundle_adjustment_tpu_torch.ops import hamming_kernel

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)


def _words(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def _case(seed, n1, n2, invalid_frac=0.1):
    """Random words with planted ties (duplicate train rows, queries equal
    to a train row or one bit away from it) and invalid train slots."""
    rng = np.random.default_rng(seed)
    d1, d2 = _words(rng, n1), _words(rng, n2)
    if n2 > 1:
        d2[1::3] = d2[0::3][: len(d2[1::3])]
    d1[::4] = d2[np.arange(0, n1, 4) % n2]
    d1[1::5] = d2[np.arange(1, n1, 5) % n2] ^ np.uint32(1 << 7)
    valid2 = rng.random(n2) > invalid_frac
    return d1, d2, valid2


def _port(a):
    return convert.descriptors(a, device="cpu")


@pytest.mark.parametrize("n1,n2", [(130, 200), (257, 383), (64, 1), (5, 2)])
def test_knn2_plain_matches_xla_oracle(n1, n2):
    """best, idx and second agree exactly with hamming.knn2, ties and
    invalid train slots included, at sizes that are not multiples of 128."""
    d1, d2, valid2 = _case(n1 + n2, n1, n2)
    jb, ji, js = jham.knn2(jnp.asarray(d1), jnp.asarray(d2), None, jnp.asarray(valid2))
    tb, ti, ts = hamming_kernel.knn2_fused(_port(d1), _port(d2), torch.as_tensor(valid2))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if n2 > 1:
        assert (tb.numpy() == ts.numpy()).any(), "the case plants no ties"


@pytest.mark.parametrize("n1,n2", [(130, 200), (300, 129)])
def test_knn2_plain_matches_pallas_interpret(n1, n2):
    """Against knn2_pallas(interpret=True): exact on every row whose best
    and second come from valid train slots.  The Pallas kernel adds
    INVALID_DIST to an invalid slot's count (so 1e9 + d, rounded in f32)
    where the port scores exactly INVALID_DIST, as the XLA oracle does; on
    the other rows only the ratio test's verdict is compared, and it agrees
    because both values fail the best < INVALID_DIST gate."""
    d1, d2, valid2 = _case(7 * n1 + n2, n1, n2, invalid_frac=0.3)
    jb, ji, js = (np.asarray(x) for x in knn2_pallas(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid2), interpret=True))
    tb, ti, ts = (x.numpy() for x in hamming_kernel.knn2_fused(
        _port(d1), _port(d2), torch.as_tensor(valid2)))
    real = ts < tham.INVALID_DIST
    assert real.mean() > 0.9
    np.testing.assert_array_equal(tb[real], jb[real])
    np.testing.assert_array_equal(ti[real], ji[real])
    np.testing.assert_array_equal(ts[real], js[real])
    np.testing.assert_array_equal(
        np.asarray(jham.ratio_test_mask(jnp.asarray(jb), jnp.asarray(js), 0.75)),
        tham.ratio_test_mask(torch.as_tensor(tb), torch.as_tensor(ts), 0.75).numpy())


@pytest.mark.parametrize("cross_check", [False, True])
def test_match_matches_jax(cross_check):
    d1, d2, valid2 = _case(11, 190, 170)
    valid1 = np.random.default_rng(12).random(190) > 0.05
    ji, jm, jb = (np.asarray(x) for x in jham.match(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid1), jnp.asarray(valid2),
        ratio=0.8, cross_check=cross_check))
    ti, tm, tb = (x.numpy() for x in tham.match(
        _port(d1), _port(d2), torch.as_tensor(valid1), torch.as_tensor(valid2),
        ratio=0.8, cross_check=cross_check))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)
    assert tm.sum() > 20


def test_pack_and_unpack_bits_match_jax():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, size=(37, 32), dtype=np.uint8)
    jw = np.asarray(jham.pack_u8_to_u32(jnp.asarray(u8)))
    tw = tham.pack_u8_to_u32(torch.as_tensor(u8))
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(convert.descriptors_to_u32(tw), jw)
    np.testing.assert_array_equal(tham.unpack_bits(tw).numpy(),
                                  np.asarray(jham.unpack_bits(jnp.asarray(jw))))
    np.testing.assert_array_equal(
        tham.hamming_matrix(tw[:20], tw[17:]).numpy(),
        np.asarray(jham.hamming_matrix(jnp.asarray(jw[:20]), jnp.asarray(jw[17:]))))


def _chunk_results(d1, d2, valid2, bounds):
    """knn2_plain on each train chunk [bounds[i], bounds[i+1]), its indices
    offset to the whole set's."""
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        b, i, s = hamming_kernel.knn2_plain(d1, d2[lo:hi], valid2[lo:hi])
        out.append((b, i + lo, s))
    return out


# chunk bounds over a 37-row train set: one-row chunks, and ties and invalid
# rows across chunk boundaries (_merge_case)
MERGE_BOUNDS = [
    [0, 1, 2, 10, 11, 25, 37],
    [0, 9, 10, 20, 36, 37],
    [0, 18, 19, 37],
]


def _merge_case(seed):
    d1, d2, valid2 = _case(seed, 50, 37, invalid_frac=0.2)
    d2[10] = d2[9]              # a duplicate across the boundary at 10
    d2[25] = d2[24]
    d2[19] = d2[17]
    d1[:6] = d2[[9, 10, 24, 25, 17, 19]]   # queries whose best is tied across chunks
    valid2[[0, 1, 36]] = False  # invalid one-row chunks
    return d1, d2, valid2


@pytest.mark.parametrize("bounds", MERGE_BOUNDS, ids=lambda b: f"{len(b) - 1}chunks")
def test_split_merge_rule_equals_one_scan(bounds):
    """The kernel's split merge (merge_top2: best the lexicographic minimum of
    (distance, index), second the smallest of the other candidates) gives,
    in every order and as a tree, knn2_plain on the whole train set and the
    JAX package's hamming.knn2, bit for bit."""
    d1, d2, valid2 = _merge_case(len(bounds))
    d1t, d2t, v2t = _port(d1), _port(d2), torch.as_tensor(valid2)
    whole = hamming_kernel.knn2_plain(d1t, d2t, v2t)
    jax_whole = [np.asarray(x) for x in jham.knn2(jnp.asarray(d1), jnp.asarray(d2), None,
                                                    jnp.asarray(valid2))]
    for a, b in zip(whole, jax_whole):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (whole[0] == whole[2]).any(), "the case plants no tie"
    parts = _chunk_results(d1t, d2t, v2t, bounds)
    merged = []
    for order in itertools.permutations(range(len(parts))):
        acc = parts[order[0]]
        for k in order[1:]:
            acc = hamming_kernel.merge_top2(acc, parts[k])
        merged.append(acc)
    tree = list(parts)
    while len(tree) > 1:
        tree = [hamming_kernel.merge_top2(*tree[i:i + 2]) if i + 1 < len(tree) else tree[i]
                for i in range(0, len(tree), 2)]
    merged.append(tree[0])
    for m in merged:
        for a, b in zip(m, whole):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n1,n2", [(4000, 4000), (4001, 2999), (4000, 12), (4000, 1), (5, 700)])
def test_split_plan_covers_the_train_set_and_merges_exactly(n1, n2):
    """split_plan leaves no split empty and covers every train row; merging
    knn2_plain over its splits in split order (what the kernel's second pass
    does) equals knn2_plain on the whole set.  At the main path's 4000 x 4000
    the grid is at least four blocks per SM of an H100 (132 SMs)."""
    splits, rows = hamming_kernel.split_plan(n1, n2, 132)
    assert splits >= 1 and (splits - 1) * rows < n2 <= splits * rows
    if (n1, n2) == (4000, 4000):
        assert -(-n1 // hamming_kernel.QUERY_TILE) * splits >= 4 * 132
    m = min(n1, 300)             # the plain check on the first queries only
    d1, d2, valid2 = _case(n1 + n2, m, n2)
    d1t, d2t, v2t = _port(d1), _port(d2), torch.as_tensor(valid2)
    bounds = [min(n2, k * rows) for k in range(splits + 1)]
    parts = _chunk_results(d1t, d2t, v2t, bounds)
    acc = parts[0]
    for part in parts[1:]:
        acc = hamming_kernel.merge_top2(acc, part)
    for a, b in zip(acc, hamming_kernel.knn2_plain(d1t, d2t, v2t)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_checks_its_inputs():
    d = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        hamming_kernel.knn2_fused(d.to(torch.int64), d)
    with pytest.raises(ValueError):
        hamming_kernel.knn2_fused(d[:, :7], d)
    with pytest.raises(ValueError):
        hamming_kernel.knn2_fused(d, d, torch.ones(3, dtype=torch.bool))



@pytest.mark.parametrize("n1,n2", [(130, 200), (64, 1), (5, 2)])
def test_hamming_matrix_popcount_matches_jax(n1, n2):
    """The popcount(XOR) oracle equals the JAX package's exactly, as int32,
    and equals the bit-product distance matrix."""
    d1, d2, _ = _case(n1 * 7 + n2, n1, n2)
    want = np.asarray(jham.hamming_matrix_popcount(jnp.asarray(d1), jnp.asarray(d2)))
    got = tham.hamming_matrix_popcount(_port(d1), _port(d2))
    assert got.dtype == torch.int32 and got.shape == (n1, n2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tham.hamming_matrix(_port(d1), _port(d2)).numpy())
