"""The port's cluster matmul against the reference's Pallas kernel.

On the CPU ``repro_torch``'s ``cluster_matmul`` runs its plain version
(float32 product, output in a's type); the reference runs its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` does.  Same inputs
from ``np.random.default_rng``, compared in float32 at that file's ``TOL``
(rtol = atol = 2e-4 for float32, 2e-2 for bfloat16).  The CUDA kernel
itself is held against the plain version by the ``cuda``-marked test
(``pytest -m cuda tests/test_torch_cluster_matmul.py`` on a GPU machine).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cluster_matmul import cluster_matmul as j_matmul
from repro_torch.kernels.cluster_matmul import cluster_matmul
from repro_torch.kernels.cluster_matmul import kernel as K
from repro_torch.kernels.cluster_matmul import ref as R

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SHAPES = [(128, 128, 128), (256, 384, 512), (384, 256, 128), (64, 64, 64)]


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _both(a, b, dtype, **tiles):
    """(port on the CPU, reference in interpret mode), as float32 numpy;
    each side rounds the float32 inputs to ``dtype`` itself (both round
    to nearest even)."""
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    out = cluster_matmul(torch.from_numpy(a).to(td),
                         torch.from_numpy(b).to(td), **tiles)
    ref = j_matmul(jnp.asarray(a).astype(jd), jnp.asarray(b).astype(jd),
                   interpret=True, **tiles)
    assert out.dtype == td and ref.dtype == jd
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_reference_kernel(m, k, n, dtype):
    out, ref = _both(*_inputs(m, k, n), dtype)
    assert out.shape == (m, n)
    np.testing.assert_allclose(out, ref, **TOL[dtype])


@pytest.mark.parametrize("tiles", [dict(bm=64, bn=64, bk=64),
                                   dict(bm=128, bn=64, bk=32)])
def test_smaller_tiles_match_reference(tiles):
    out, ref = _both(*_inputs(128, 128, 192, seed=1), "float32", **tiles)
    np.testing.assert_allclose(out, ref, **TOL["float32"])


@pytest.mark.parametrize("m,k,n", [(200, 128, 128), (128, 130, 128),
                                   (128, 128, 300)])
def test_untiled_shape_raises_the_reference_assertion(m, k, n):
    a, b = _inputs(m, k, n)
    with pytest.raises(AssertionError) as jerr:
        j_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    with pytest.raises(AssertionError) as terr:
        cluster_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert str(terr.value) == str(jerr.value)
    assert "not tiled by" in str(terr.value)


def test_inner_dimension_mismatch_raises():
    a, _ = _inputs(64, 64, 64)
    b = np.zeros((32, 64), np.float32)
    with pytest.raises(AssertionError) as jerr:
        j_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    with pytest.raises(AssertionError) as terr:
        cluster_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert str(terr.value) == str(jerr.value)


def test_mixed_and_unsupported_dtypes_are_refused():
    """A deliberate difference: the reference promotes inside ``jnp.dot``
    (f32 @ bf16 gives a float32 result); the port refuses."""
    a, b = _inputs(64, 64, 64)
    promoted = j_matmul(jnp.asarray(a), jnp.asarray(b).astype(jnp.bfloat16),
                        interpret=True)
    assert promoted.dtype == jnp.float32
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(TypeError, match="mixed dtypes"):
        cluster_matmul(ta, tb.to(torch.bfloat16))
    for dt in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match="not supported"):
            cluster_matmul(ta.to(dt), tb.to(dt))
    with pytest.raises(ValueError, match="2-D"):
        cluster_matmul(ta[None], tb)


def test_transposed_view_is_made_contiguous():
    a, b = _inputs(128, 256, 64, seed=2)
    at = torch.from_numpy(np.ascontiguousarray(a.T)).T      # a, as a view
    assert not at.is_contiguous()
    out = cluster_matmul(at, torch.from_numpy(b))
    ref = j_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **TOL["float32"])


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    a, b = (torch.from_numpy(x) for x in _inputs(64, 64, 64))
    K.launches.reset()
    R.calls.reset()
    cluster_matmul(a, b)
    assert (K.launches.n, R.calls.n) == (0, 1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        K.matmul(a, b)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card, at
    shapes with partial tiles and small tiles, and on a transposed view
    through ``ops``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_cluster_matmul.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (m, k, n) in SHAPES + [(5, 7, 3), (96, 100, 120), (256, 256, 256),
                               (768, 768, 768)]:
        a, b = _inputs(m, k, n)
        for dtype in ("float32", "bfloat16"):
            td = getattr(torch, dtype)
            ta = torch.from_numpy(a).to("cuda", td)
            tb = torch.from_numpy(b).to("cuda", td)
            before = K.launches.n
            out = cluster_matmul(ta, tb)
            torch.cuda.synchronize()
            assert K.launches.n == before + 1
            ref = R.cluster_matmul_ref(ta, tb)
            assert out.dtype == td
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       ref.float().cpu().numpy(),
                                       **TOL[dtype])
    a, b = _inputs(128, 256, 64, seed=2)
    at = torch.from_numpy(np.ascontiguousarray(a.T)).cuda().T
    out = cluster_matmul(at, torch.from_numpy(b).cuda())
    np.testing.assert_allclose(out.cpu().numpy(), a @ b, **TOL["float32"])
    with pytest.raises(ValueError, match="contiguous"):
        K.matmul(at, torch.from_numpy(b).cuda())


@pytest.mark.parametrize("dtype,m,k,n,aligned,want", [
    (torch.bfloat16, 4096, 4096, 4096, True, "wgmma"),
    (torch.bfloat16, 1024, 4096, 11008, True, "wgmma"),   # yi-6b's MLP
    (torch.bfloat16, 1000, 1032, 776, True, "wgmma"),     # ragged tiles
    (torch.bfloat16, 256, 256, 256, True, "wgmma"),
    (torch.bfloat16, 100, 36, 20, True, "general"),       # k % 8 == 4
    (torch.bfloat16, 64, 64, 60, True, "general"),        # n % 8 == 4
    (torch.bfloat16, 3, 5, 7, True, "general"),
    (torch.bfloat16, 8, 0, 8, True, "general"),           # empty k
    (torch.bfloat16, 256, 256, 256, False, "general"),    # a base off 16
    (torch.float32, 4096, 4096, 4096, True, "general"),   # every float32
    (torch.float32, 128, 128, 128, True, "general"),      # one 128^2 tile
    (torch.float32, 1024, 4096, 11008, True, "general"),  # yi-6b's MLP
    (torch.float32, 100, 36, 20, True, "general"),        # one tile
    (torch.float32, 1000, 1032, 776, True, "general"),    # 56 tiles
    (torch.float32, 2048, 128, 1152, True, "general"),    # 144 tiles
    (torch.float32, 1000, 1032, 2200, True, "general"),   # 144, ragged
    (torch.float32, 1000, 1032, 2048, True, "general"),   # 128 tiles
    (torch.float32, 128, 130, 128, True, "general"),      # k % 4 == 2
    (torch.float32, 64, 64, 62, True, "general"),         # n % 4 == 2
    (torch.float32, 127, 127, 127, True, "general"),      # odd everything
    (torch.float32, 8, 0, 8, True, "general"),            # empty k
    (torch.float32, 256, 256, 256, False, "general"),     # a base off 16
])
def test_route_by_type_shape_and_alignment(dtype, m, k, n, aligned, want):
    assert K.route(dtype, m, k, n, aligned=aligned) == want


def test_ragged_wgmma_shape_is_outside_the_reference_contract():
    """1000 x 1032 @ 1032 x 776 takes the wgmma branch with partial tiles
    in every dimension; ``ops`` (the reference's tile contract) refuses it,
    so ``chip_smoke.py`` phase 7 calls ``kernel.matmul`` directly."""
    a, b = _inputs(1000, 1032, 776)
    with pytest.raises(AssertionError, match="not tiled by"):
        cluster_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert K.route(torch.bfloat16, 1000, 1032, 776) == K.WGMMA


@pytest.mark.cuda
def test_wgmma_branch_matches_plain_version():
    """The wgmma branch against the plain version on the card, at shapes
    with m != k != n and partial tiles (a swapped descriptor stride or a
    dropped edge shows there), and the general branch at shapes that break
    the 16-byte rule; each branch's launches are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_cluster_matmul.py)")
    for (m, k, n) in [(128, 64, 256), (256, 384, 512), (1000, 1032, 776),
                      (72, 200, 48), (300, 8, 520), (100, 36, 20),
                      (5, 7, 3)]:
        a, b = _inputs(m, k, n, seed=3)
        ta = torch.from_numpy(a).to("cuda", torch.bfloat16)
        tb = (torch.from_numpy(b) / np.sqrt(k)).to("cuda", torch.bfloat16)
        want = K.route(torch.bfloat16, m, k, n)
        before = (K.launches.n, K.wgmma_launches.n)
        out = K.matmul(ta, tb)
        torch.cuda.synchronize()
        assert (K.launches.n - before[0],
                K.wgmma_launches.n - before[1]) == \
            (1, int(want == K.WGMMA)), (m, k, n)
        ref = R.cluster_matmul_ref(ta, tb)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   **TOL["bfloat16"])


@pytest.mark.cuda
def test_f32_ring_branch_matches_plain_version():
    """Aligned float32 products, the shapes a 16-byte-copy ring kernel once
    took (grids that fill a wave, ragged edges: m, n and k not multiples of
    the 128 x 128 x 16 tile, so the zero-filled copies at every edge; k <
    16; tile-crossing small ones), against the plain version on the card,
    with A aligned and 4 bytes past a 16-byte boundary: every one takes
    the general branch, on the tile and K splits its plan picks, as the
    launches (all, split) show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_cluster_matmul.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (m, k, n) in [(2048, 128, 1152), (1000, 1032, 2200),
                      (2100, 4, 1040), (1700, 36, 1548), (1900, 200, 1300),
                      (128, 128, 128), (256, 384, 512), (1024, 512, 768),
                      (1000, 1032, 776), (72, 200, 48), (300, 4, 520),
                      (5, 8, 12), (130, 36, 20), (100, 37, 20),
                      (64, 64, 62)]:
        a, b = _inputs(m, k, n, seed=4)
        ta = torch.from_numpy(a).cuda()
        tb = (torch.from_numpy(b) / np.sqrt(k)).cuda()
        ref = R.cluster_matmul_ref(ta, tb)
        # the same values at a base 4 bytes past a 16-byte boundary
        off = torch.empty(m * k + 1, device="cuda")[1:].view(m, k)
        off.copy_(ta)
        splits = K.general_plan(m, k, n)[1]
        for x, aligned in ((ta, True), (off, False)):
            assert K.route(torch.float32, m, k, n, aligned=aligned) \
                == K.GENERAL, (m, k, n)
            before = (K.launches.n, K.split_launches.n)
            out = K.matmul(x, tb)
            torch.cuda.synchronize()
            assert (K.launches.n - before[0],
                    K.split_launches.n - before[1]) == \
                (1, int(splits > 1)), (m, k, n, aligned)
            np.testing.assert_allclose(out.cpu().numpy(),
                                       ref.cpu().numpy(), **TOL["float32"])


def split_k_emulation(a: np.ndarray, b: np.ndarray, splits: int
                      ) -> np.ndarray:
    """The general float32 kernel's arithmetic, for the tests only: K in
    16-deep tiles dealt to ``splits`` splits of ceil(k_tiles / splits)
    tiles each; within a split every element of C is a chain of float32
    FMAs in k order (each FMA rounded once: the float64 product of two
    float32 values is exact); the partials are then summed in split order,
    ((p_0 + p_1) + p_2) + ..., in float32."""
    m, k = a.shape
    k_tiles = -(-k // K.BK)
    per = -(-k_tiles // splits) if k_tiles else 0
    out = np.zeros((m, b.shape[1]), np.float32)
    for s in range(splits):
        part = np.zeros_like(out)
        for kk in range(s * per * K.BK, min(k, (s + 1) * per * K.BK)):
            part = (np.outer(a[:, kk], b[kk]).astype(np.float64)
                    + part).astype(np.float32)
        out = part if s == 0 else (out + part).astype(np.float32)
    return out


@pytest.mark.parametrize("m,k,n", [(127, 127, 127), (3, 5, 7),
                                   (100, 36, 20)])
@pytest.mark.parametrize("splits", [None, 1, 3, 8])
def test_split_k_order_matches_reference_kernel(m, k, n, splits):
    """The general kernel's split-K summation order (its plan's splits, or
    forced ones) against the reference's Pallas kernel in interpret mode,
    within the float32 bar: a different summation order, well inside it
    for A ~ N(0, 1), B ~ N(0, 1/k)."""
    a, b = _inputs(m, k, n, seed=5)
    b = b / np.float32(np.sqrt(k))
    if splits is None:
        splits = K.general_plan(m, k, n)[1]
    k_tiles = -(-k // K.BK)
    splits = min(splits, k_tiles)
    emu = split_k_emulation(a, b, splits)
    ref = np.asarray(j_matmul(jnp.asarray(a), jnp.asarray(b),
                              interpret=True), np.float32)
    np.testing.assert_allclose(emu, ref, **TOL["float32"])


@pytest.mark.parametrize("m,k,n,want", [
    (4096, 4096, 4096, (128, 1)),      # 1,024 tiles of 128 x 128
    (1024, 4096, 11008, (128, 1)),     # yi-6b's MLP: 688 tiles
    (127, 127, 127, (64, 2)),          # 4 tiles of 64 x 64, 8 k-tiles
    (256, 256, 256, (64, 4)),          # 16 tiles, 16 k-tiles
    (768, 768, 768, (64, 3)),          # 144 tiles: 432 blocks
    (1000, 1032, 776, (64, 2)),        # 208 tiles: 416 blocks
    (100, 36, 20, (64, 1)),            # 3 k-tiles: too few to split
    (3, 5, 7, (64, 1)),                # one k-tile
    (8, 0, 8, (64, 1)),                # empty k
])
def test_general_plan_by_shape(m, k, n, want):
    assert K.general_plan(m, k, n) == want


def test_general_plan_leaves_no_split_empty():
    """Every split the plan asks for gets K tiles: (splits - 1) *
    ceil(k_tiles / splits) < k_tiles, the C entry's own check."""
    for m in (1, 63, 64, 127, 500, 1500):
        for n in (1, 65, 300, 2000):
            for k in (1, 15, 16, 17, 100, 333, 4096, 20000):
                tile, splits = K.general_plan(m, k, n)
                assert tile in (64, 128) and splits >= 1
                k_tiles = -(-k // K.BK)
                assert (splits - 1) * -(-k_tiles // splits) < k_tiles, \
                    (m, k, n, splits)
                if tile == 128:
                    assert splits == 1


@pytest.mark.cuda
def test_general_f32_branch_matches_plain_version():
    """The general float32 branch against the plain version on the card
    at odd shapes and at shapes with A 4 bytes past a 16-byte boundary,
    K split over blocks and not; the launches (all, split) are counted and
    two calls give equal outputs (the split order is fixed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_cluster_matmul.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (m, k, n, offset) in [(127, 127, 127, False), (3, 5, 7, False),
                              (1, 1, 1, False), (100, 37, 21, False),
                              (8, 0, 8, False), (100, 36, 20, True),
                              (256, 256, 256, True), (768, 768, 768, True),
                              (1000, 1032, 776, True),
                              (1024, 512, 1030, True), (65, 4001, 67, True)]:
        a, b = _inputs(m, k, n, seed=6)
        ta = torch.from_numpy(a).cuda()
        tb = (torch.from_numpy(b) / np.sqrt(max(k, 1))).cuda()
        if offset:
            off = torch.empty(m * k + 1, device="cuda")[1:].view(m, k)
            ta = off.copy_(ta)
        assert K.route(torch.float32, m, k, n,
                       aligned=not offset) == K.GENERAL, (m, k, n)
        splits = K.general_plan(m, k, n)[1]
        before = (K.launches.n, K.split_launches.n)
        out = K.matmul(ta, tb)
        again = K.matmul(ta, tb)
        torch.cuda.synchronize()
        assert (K.launches.n - before[0], K.split_launches.n - before[1]) \
            == (2, 2 * int(splits > 1)), (m, k, n)
        assert torch.equal(out, again), (m, k, n)
        ref = R.cluster_matmul_ref(ta, tb)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   **TOL["float32"])


def bf16_split_k_emulation(a: np.ndarray, b: np.ndarray, splits: int,
                           shift: int = 0) -> np.ndarray:
    """The general bfloat16 kernel's arithmetic, for the tests only: the
    inputs rounded to bfloat16; K in 32-deep tiles, the first starting
    ``shift`` elements before k = 0 (A's shift, ``kernel.a_access``),
    dealt to ``splits`` splits of ceil(k_tiles / splits) tiles each;
    within a split every
    element of C is a float32 sum in k order of exact products (two
    bfloat16 values multiply exactly in float32); the partials summed in
    split order, ((p_0 + p_1) + p_2) + ..., in float32, then rounded once
    to bfloat16 (nearest even)."""
    a = torch.from_numpy(a).to(torch.bfloat16).double().numpy()
    b = torch.from_numpy(b).to(torch.bfloat16).double().numpy()
    m, k = a.shape
    k_tiles = -(-(k + shift) // K.BK_BF16)
    per = -(-k_tiles // splits) if k_tiles else 0
    out = np.zeros((m, b.shape[1]), np.float32)
    for s in range(splits):
        part = np.zeros_like(out)
        for kk in range(max(0, s * per * K.BK_BF16 - shift),
                        min(k, (s + 1) * per * K.BK_BF16 - shift)):
            part = (np.outer(a[:, kk], b[kk]) + part).astype(np.float32)
        out = part if s == 0 else (out + part).astype(np.float32)
    return torch.from_numpy(out).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("m,k,n", [(127, 127, 127), (3, 5, 7),
                                   (100, 36, 20), (65, 4001, 67)])
@pytest.mark.parametrize("splits", [None, 1, 3, 8])
def test_bf16_split_k_order_matches_reference_kernel(m, k, n, splits):
    """The general bfloat16 kernel's split-K arithmetic (its plan's splits,
    or forced ones): float32 partials summed in split order and rounded
    once to bfloat16, against the reference's Pallas kernel in interpret
    mode on the same bfloat16 inputs (one grid step: tiles of the whole
    matrices, which the reference's contract takes at any shape), within
    the bfloat16 bar."""
    a, b = _inputs(m, k, n, seed=7)
    b = b / np.float32(np.sqrt(k))
    if splits is None:
        splits = K.general_plan(m, k, n, torch.bfloat16)[1]
    splits = min(splits, -(-k // K.BK_BF16))
    emu = bf16_split_k_emulation(a, b, splits)
    ref = np.asarray(j_matmul(jnp.asarray(a).astype(jnp.bfloat16),
                              jnp.asarray(b).astype(jnp.bfloat16),
                              bm=m, bn=n, bk=k, interpret=True), np.float32)
    np.testing.assert_allclose(emu, ref, **TOL["bfloat16"])


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (100, 40, 20),
                                   (64, 4096, 64)])
@pytest.mark.parametrize("shift", [1, 7])
@pytest.mark.parametrize("splits", [None, 3])
def test_bf16_shifted_k_tiles_match_reference_kernel(m, k, n, shift, splits):
    """A's K tiles shifted ``shift`` elements early (a base off 16 bytes
    with rows of whole 16-byte chunks), the first and last tiles holding
    k outside [0, K), split as the plan says for k + shift or forced:
    against the reference's Pallas kernel in interpret mode at the
    bfloat16 bar."""
    a, b = _inputs(m, k, n, seed=10)
    b = b / np.float32(np.sqrt(k))
    if splits is None:
        splits = K.general_plan(m, k + shift, n, torch.bfloat16)[1]
    emu = bf16_split_k_emulation(a, b, splits, shift)
    ref = np.asarray(j_matmul(jnp.asarray(a).astype(jnp.bfloat16),
                              jnp.asarray(b).astype(jnp.bfloat16),
                              bm=m, bn=n, bk=k, interpret=True), np.float32)
    np.testing.assert_allclose(emu, ref, **TOL["bfloat16"])


@pytest.mark.parametrize("m,k,n,want", [
    (4096, 4096, 4096, (128, 1)),      # 1,024 tiles of 128 x 128
    (1024, 4096, 11008, (128, 1)),     # yi-6b's MLP: 688 tiles
    (1024, 4095, 11007, (128, 1)),     # all odd: 688 tiles
    (127, 127, 127, (64, 1)),          # 4 tiles, 4 k-tiles: too few
    (256, 256, 256, (64, 1)),          # 16 tiles, 8 k-tiles: too few
    (256, 512, 512, (64, 2)),          # 32 tiles, 16 k-tiles
    (768, 768, 768, (64, 1)),          # 144 tiles: a wave already
    (1000, 1032, 776, (64, 1)),        # 208 tiles
    (128, 8193, 128, (64, 29)),        # 4 tiles, 257 k-tiles: 9 a split
    (65, 4001, 67, (64, 14)),          # 4 tiles, 126 k-tiles: 9 a split
    (100, 36, 20, (64, 1)),            # 2 k-tiles
    (3, 5, 7, (64, 1)),                # one k-tile
    (8, 0, 8, (64, 1)),                # empty k
])
def test_general_plan_by_shape_bf16(m, k, n, want):
    """bfloat16 takes 32-deep K tiles, at least 8 a split, and splits
    only up to one block an SM (a 64 x 64 tile walks K fast on the tensor
    cores); the float32 plan is pinned above."""
    assert K.general_plan(m, k, n, torch.bfloat16) == want


def test_general_plan_bf16_leaves_no_split_empty():
    """As ``test_general_plan_leaves_no_split_empty``, for bfloat16's
    32-deep K tiles (the C entry's own check)."""
    for m in (1, 63, 64, 127, 500, 1500):
        for n in (1, 65, 300, 2000):
            for k in (1, 31, 32, 33, 100, 333, 4096, 20000):
                tile, splits = K.general_plan(m, k, n, torch.bfloat16)
                assert tile in (64, 128) and splits >= 1
                k_tiles = -(-k // K.BK_BF16)
                assert (splits - 1) * -(-k_tiles // splits) < k_tiles, \
                    (m, k, n, splits)
                if tile == 128:
                    assert splits == 1


@pytest.mark.parametrize("address,row_bytes,want", [
    (0, 8192, 16),        # aligned, k % 8 == 0
    (512, 72, 8),         # k = 36: rows of 72 bytes
    (256, 40, 8),         # k = 20
    (0, 260, 4),          # k = 130
    (0, 254, 2),          # k = 127: odd
    (2, 8192, 2),         # a [1:] view: 2 bytes past 16
    (4, 8192, 4),         # 4 bytes past
    (8, 8192, 8),         # 8 bytes past
    (12, 8192, 4),
    (16, 8190, 2),        # k = 4095
    (64, 0, 16),          # k = 0: the base alone decides
])
def test_access_width_by_base_and_pitch(address, row_bytes, want):
    assert K.access_width(address, row_bytes) == want


@pytest.mark.parametrize("address,row_bytes,want", [
    (0, 8192, (16, 0)),     # aligned
    (2, 8192, (16, 1)),     # a [1:] view: 16-byte copies, K shifted by 1
    (4, 8192, (16, 2)),
    (8, 8192, (16, 4)),
    (14, 8192, (16, 7)),
    (2, 72, (8, 1)),        # k = 36: rows of 72 bytes
    (6, 72, (8, 3)),
    (2, 260, (4, 1)),       # k = 130
    (0, 254, (2, 0)),       # k = 127: through registers
    (2, 254, (2, 0)),
    (2, 0, (2, 0)),         # k = 0: nothing read
])
def test_a_access_by_pitch_and_base(address, row_bytes, want):
    """A's width comes from its row pitch alone, its base deciding the
    K shift that keeps every copy aligned to that width."""
    w, shift = K.a_access(address, row_bytes)
    assert (w, shift) == want
    assert (address - 2 * shift) % w == 0 and 2 * shift < max(w, 2)


@pytest.mark.parametrize("m,k,n,a_off,b_off,want", [
    (4096, 4096, 4096, 0, 0, "wgmma"),
    (4096, 4096, 4096, 2, 0, "general"),      # A: 2-byte accesses
    (4096, 4096, 4096, 4, 0, "general"),      # A: 4-byte cp.async
    (4096, 4096, 4096, 8, 0, "general"),      # A: 8-byte cp.async
    (4096, 4096, 4096, 0, 2, "general"),      # B: 2-byte accesses
    (1024, 4095, 11007, 0, 0, "general"),     # odd k and n: 2 and 2
    (1024, 4100, 11008, 0, 0, "general"),     # k % 8 == 4: A 8 bytes
    (1024, 4096, 11004, 0, 0, "general"),     # n % 8 == 4: B 8 bytes
    (768, 768, 768, 0, 8, "general"),         # B 8 bytes off
    (768, 768, 768, 0, 0, "wgmma"),           # a small grid: wgmma too
    (1000, 1032, 776, 0, 0, "wgmma"),
])
def test_route_by_access_width_class(m, k, n, a_off, b_off, want):
    """A bfloat16 product's branch for each class of access width of its
    operands (a base ``a_off`` / ``b_off`` bytes past 16, rows of 2k and
    2n bytes): wgmma exactly when every base and row pitch takes 16-byte
    accesses, whatever the grid (the general kernel did not beat wgmma at
    every small grid timed)."""
    wa = K.access_width(4096 + a_off, 2 * k)
    wb = K.access_width(4096 + b_off, 2 * n)
    aligned = a_off % 16 == 0 and b_off % 16 == 0
    assert (wa == wb == 16) == (aligned and k % 8 == 0 and n % 8 == 0)
    assert K.route(torch.bfloat16, m, k, n, aligned=aligned) == want


def _offset(x: torch.Tensor, off_bytes: int) -> torch.Tensor:
    """x's values at a base ``off_bytes`` past the allocation's start,
    NaN before and after them: a kernel that multiplied a neighbour of
    the matrix, even by a zero, would put a NaN in the product."""
    e = off_bytes // x.element_size()
    flat = torch.full((x.numel() + e + 16,), float("nan"), dtype=x.dtype,
                      device=x.device)
    return flat[e:e + x.numel()].view(x.shape).copy_(x)


@pytest.mark.cuda
def test_general_bf16_branch_matches_plain_version():
    """The general bfloat16 branch (mma.sync) against the plain version on
    the card at odd k, odd n and k = 0, at A or B 2, 4, 8 and 14 bytes past
    a 16-byte boundary (each access width, A's K shifted by 1-7), on 128 x
    128 tiles and on 64 x 64 tiles with K split and not; the launches
    (all, wgmma, split) are counted and two calls give equal outputs (the
    split order is fixed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_cluster_matmul.py)")
    for (m, k, n, a_off, b_off) in [
            (127, 127, 127, 0, 0), (3, 5, 7, 0, 0), (1, 1, 1, 0, 0),
            (100, 37, 21, 0, 0), (8, 0, 8, 0, 0), (8, 0, 8, 2, 2),
            (100, 36, 20, 2, 0), (256, 256, 256, 2, 0), (256, 256, 256, 4, 0),
            (256, 256, 256, 8, 0), (256, 256, 256, 0, 2),
            (256, 256, 256, 0, 4), (256, 256, 256, 0, 8),
            (256, 512, 512, 2, 0), (384, 256, 128, 4, 0),
            (100, 36, 20, 4, 0), (100, 24, 50, 6, 0), (512, 512, 640, 14, 0),
            (100, 130, 60, 2, 0), (256, 256, 255, 2, 0), (300, 64, 521, 6, 0),
            (64, 4096, 64, 2, 0), (300, 64, 520, 0, 8), (768, 768, 768, 2, 0),
            (1000, 1032, 776, 2, 2), (1024, 512, 1030, 2, 0),
            (65, 4001, 67, 2, 0), (2048, 96, 2048, 2, 0),
            (2047, 95, 2049, 0, 0), (1030, 200, 2100, 4, 8),
            (1030, 200, 2100, 8, 4), (2100, 33, 1100, 2, 2)]:
        a, b = _inputs(m, k, n, seed=8)
        ta = _offset(torch.from_numpy(a).to("cuda", torch.bfloat16), a_off)
        tb = _offset((torch.from_numpy(b) / np.sqrt(max(k, 1))).to(
            "cuda", torch.bfloat16), b_off)
        case = (m, k, n, a_off, b_off)
        assert K.route(torch.bfloat16, m, k, n,
                       aligned=a_off == b_off == 0) == K.GENERAL, case
        shift = K.a_access(ta.data_ptr(), 2 * k)[1]
        splits = K.general_plan(m, k + shift, n, torch.bfloat16)[1]
        counters = (K.launches, K.wgmma_launches, K.split_launches)
        before = [c.n for c in counters]
        out = K.matmul(ta, tb)
        again = K.matmul(ta, tb)
        torch.cuda.synchronize()
        assert tuple(c.n - b0 for c, b0 in zip(counters, before)) == \
            (2, 0, 2 * int(splits > 1)), case
        assert torch.equal(out, again), case
        ref = R.cluster_matmul_ref(ta, tb)
        assert out.dtype == torch.bfloat16 and out.shape == (m, n)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   **TOL["bfloat16"])


@pytest.mark.cuda
def test_two_builds_launch_in_one_process():
    """Two builds of the kernel source loaded in one process (as an A/B of
    two commits loads them) both launch their 128 x 128 kernels, which
    need the shared-memory opt-in: the flag that records it is a static
    local of a template, and built without ``-fno-gnu-unique`` it was one
    object across both libraries, so the second skipped its opt-in and
    its launch failed (CUDA error 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_cluster_matmul.py)")
    from repro_torch.kernels import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    launch.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    copy = launch.BUILD_DIR / "cluster_matmul_second_build.cu"
    copy.write_text(K.SOURCE.read_text() + "\n// a second build\n")
    cases = []
    for dtype, k in ((torch.bfloat16, 256), (torch.float32, 128)):
        a, b = _inputs(2048, k, 1152, seed=9)
        ta = _offset(torch.from_numpy(a).to("cuda", dtype), 2)
        tb = (torch.from_numpy(b) / np.sqrt(k)).to("cuda", dtype)
        assert K.general_plan(2048, k, 1152, dtype) == (128, 1)
        cases.append((ta, tb))
    source, outs = K.SOURCE, []
    try:
        for src in (source, copy):
            K.SOURCE = src
            K._library.cache_clear()
            outs.append([K.matmul(ta, tb) for ta, tb in cases])
            torch.cuda.synchronize()
    finally:
        K.SOURCE = source
        K._library.cache_clear()
    for first, second in zip(*outs):
        assert torch.equal(first, second)
