"""The port's threefry PRNG (``repro_torch.runtime.prng``) against the live
``jax.random``: keys, ``fold_in``, bits and uniforms bit for bit, Gumbel
draws within 1e-6 (their logarithms are the backend's), over several
seeds, positions and vocabulary sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.runtime import prng

SEEDS = [0, 7, 123456789, 2**32 - 1]
POSITIONS = [0, 5, 1000, 2**31 - 1]
VOCABS = [1, 7, 256, 64000]


def test_jax_draws_in_partitionable_mode():
    """The port copies the partitionable layout of JAX's threefry bits; a
    JAX that switched layouts would change every reference draw."""
    assert jax.config.jax_threefry_partitionable is True


def _keys(seed: int, pos: int):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
    tk = prng.fold_in(prng.prng_key(torch.tensor(seed)), torch.tensor(pos))
    return jk, tk


def test_prng_key_and_fold_in_match_jax():
    assert prng.prng_key(torch.tensor(7)).tolist() == [0, 7]
    assert prng.fold_in(prng.prng_key(torch.tensor(7)),
                        torch.tensor(123)).tolist() == [2005013758,
                                                        680036494]
    for seed in SEEDS:
        np.testing.assert_array_equal(
            prng.prng_key(torch.tensor(seed)).numpy(),
            np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))
        for pos in POSITIONS:
            jk, tk = _keys(seed, pos)
            np.testing.assert_array_equal(
                tk.numpy(), np.asarray(jk).astype(np.int64))


def test_batched_keys_match_one_by_one():
    """(B, 2) keys fold and draw lane by lane, as under the reference's
    vmap."""
    seeds = torch.tensor(SEEDS)
    pos = torch.tensor(POSITIONS)
    keys = prng.fold_in(prng.prng_key(seeds), pos)
    bits = prng.random_bits(keys, 33)
    for i, (s, p) in enumerate(zip(SEEDS, POSITIONS)):
        _, tk = _keys(s, p)
        assert torch.equal(keys[i], tk)
        assert torch.equal(bits[i], prng.random_bits(tk, 33))


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_gumbel_match_jax(seed, V):
    for pos in POSITIONS[:3]:
        jk, tk = _keys(seed, pos)
        np.testing.assert_array_equal(
            prng.random_bits(tk, V).numpy(),
            np.asarray(jax.random.bits(jk, (V,), jnp.uint32)).astype(
                np.int64))
        for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                       (-2.0, 3.0), (-1e3, 1e-3)):
            ref = np.asarray(jax.random.uniform(jk, (V,), minval=lo,
                                                maxval=hi))
            ours = prng.uniform(tk, V, lo, hi).numpy()
            assert ours.dtype == np.float32
            np.testing.assert_array_equal(ours.view(np.int32),
                                          ref.view(np.int32))
        ref = np.asarray(jax.random.gumbel(jk, (V,), mode="low"))
        np.testing.assert_allclose(prng.gumbel(tk, V).numpy(), ref,
                                   rtol=0, atol=1e-6)


def test_threefry_known_answer():
    """Threefry-2x32's published known-answer vectors (Random123's, 20
    rounds), as JAX's own tests hold them."""
    z = torch.tensor(0)
    assert [int(w) for w in prng.threefry2x32(z, z, z, z)] == [
        0x6B200159, 0x99BA4EFE]
    f = torch.tensor(0xFFFFFFFF)
    assert [int(w) for w in prng.threefry2x32(f, f, f, f)] == [
        0x1CB996FC, 0xBB002BE7]
    k1, k2, x1, x2 = (torch.tensor(w) for w in (
        0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3))
    assert [int(w) for w in prng.threefry2x32(k1, k2, x1, x2)] == [
        0xC4923A9C, 0x483DF7A0]


def test_categorical_matches_jax_away_from_ties():
    """Draws equal ``jax.random.categorical``'s wherever the reference's
    top two scores are 1e-5 or more apart (none is nearer here)."""
    rng = np.random.default_rng(0)
    for V in VOCABS[1:]:
        logits = (rng.standard_normal((8, V)) * 2).astype(np.float32)
        for seed in SEEDS:
            jks = [jax.random.fold_in(jax.random.PRNGKey(seed), b)
                   for b in range(8)]
            ref = [int(jax.random.categorical(k, lg))
                   for k, lg in zip(jks, logits)]
            scores = np.stack([np.asarray(jax.random.gumbel(k, (V,))) + lg
                               for k, lg in zip(jks, logits)])
            top2 = np.sort(scores, axis=1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0] >= 1e-5).all()
            keys = prng.fold_in(prng.prng_key(torch.tensor(seed)),
                                torch.arange(8))
            ours = prng.categorical(keys, torch.from_numpy(logits))
            assert ours.tolist() == ref
