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
    (torch.float32, 4096, 4096, 4096, True, "f32_ring"),
    (torch.float32, 128, 128, 128, True, "f32_ring"),
    (torch.float32, 1024, 4096, 11008, True, "f32_ring"),  # yi-6b's MLP
    (torch.float32, 100, 36, 20, True, "f32_ring"),       # k, n % 4 == 0
    (torch.float32, 1000, 1032, 776, True, "f32_ring"),   # ragged tiles
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
    """The float32 ring branch against the plain version on the card at
    aligned shapes, at ragged ones (m, n and k not multiples of the 128 x
    128 x 16 tile: the zero-filled copies at every edge) and at k < 16;
    the same products with a base address off 16 bytes, or k or n not a
    multiple of 4, take the general branch.  Each branch's launches are
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: "
                    "pytest -m cuda tests/test_torch_cluster_matmul.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (m, k, n) in [(128, 128, 128), (256, 384, 512), (1024, 512, 768),
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
        for x, aligned in ((ta, True), (off, False)):
            want = K.route(torch.float32, m, k, n, aligned=aligned)
            assert want == (K.F32_RING if aligned and k % 4 == 0
                            and n % 4 == 0 else K.GENERAL), (m, k, n)
            before = (K.launches.n, K.ring_launches.n)
            out = K.matmul(x, tb)
            torch.cuda.synchronize()
            assert (K.launches.n - before[0],
                    K.ring_launches.n - before[1]) == \
                (1, int(want == K.F32_RING)), (m, k, n, aligned)
            np.testing.assert_allclose(out.cpu().numpy(),
                                       ref.cpu().numpy(), **TOL["float32"])
