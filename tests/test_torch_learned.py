"""The port's learned baseline (auvtpu_torch.learned) against the JAX
package's (auvtpu.learned, flax/optax) on the CPU: the committed
checkpoints load identically in both packages, the forward pass agrees at
f32 compute (rtol 1e-5) and at bf16 compute (BF16_TOL: a few bf16 ulps of
the normalised residual), three f32 Adam steps on the same batches agree
(losses rtol 1e-4, parameters atol 1e-5), and checkpoints round-trip
between the packages."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from auvtpu import learned as jl
from auvtpu.config import Extent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import fill_window_mean as j_fill_window_mean
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch import convert
from auvtpu_torch import learned as tl
from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.ops import fill_window_mean

torch.set_num_threads(1)

optax = pytest.importorskip("optax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(glob.glob(os.path.join(REPO, "results", "learned_*_w16d2.npz")))
# bf16 compute: XLA:CPU and torch round the convolutions, GELUs and sums of
# bf16 tensors at different points, so the normalised residual moves by a
# few bf16 ulps (2^-8 relative): bounded at 0.01 of the tile's std (the
# fill's unit; seen 0.0024 on the 96x112 tile)
BF16_TOL = 0.01
W_, D_, TILE = 8, 1, 32  # the JAX package's test net


def _tree_to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def tiles():
    reduced, rc, truth = mask_grid(shelf_seamount(96, 112), 0.2, seed=3)
    ext = Extent(0.0, 111.0, 0.0, 95.0)
    jg = JGrid.from_nan_array(reduced, ext)
    tg = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), ext.min_lon, ext.max_lon, ext.min_lat,
                          ext.max_lat, "cpu")
    return jg, tg, rc, truth


@pytest.fixture(scope="module")
def committed():
    jp, w, d = jl.load_params(CHECKPOINTS[0])
    return jp, convert.learned_params_from_arrays(_tree_to_numpy(jp), "cpu"), w, d


def test_committed_checkpoints_load_identically_in_both_packages():
    assert len(CHECKPOINTS) == 3
    for path in CHECKPOINTS:
        jp, jw, jd = jl.load_params(path)
        tp, tw, td = tl.load_params(path, device="cpu")
        assert (tw, td) == (jw, jd) == (16, 2)
        from_tree = convert.learned_params_from_arrays(_tree_to_numpy(jp), "cpu")
        with np.load(path) as z:
            from_npz = convert.learned_params_from_arrays({k: z[k] for k in z.files if "/" in k}, "cpu")
        assert tp.keys() == from_tree.keys() == from_npz.keys()
        assert set(tp) == set(tl.MaskedConvInpainter(16, 2).state_dict())
        for k in tp:
            assert tp[k].dtype == torch.float32
            assert torch.equal(tp[k], from_tree[k]) and torch.equal(tp[k], from_npz[k])
        # HWIO -> OIHW
        np.testing.assert_array_equal(tp["stem.weight"].numpy(), np.asarray(jp["stem"]["kernel"]).transpose(3, 2, 0, 1))


def test_load_params_refuses_a_mismatched_checkpoint(tmp_path):
    with np.load(CHECKPOINTS[0]) as z:
        arrs = {k: z[k] for k in z.files}
    arrs["__depth__"] = np.asarray(3)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **arrs)
    with pytest.raises(ValueError, match="depth 3"):
        tl.load_params(path, device="cpu")


def _jax_residual(jp, jg, mf, w, d, dtype):
    model = jl.MaskedConvInpainter(width=w, depth=d, compute_dtype=dtype)
    x, _, std = jl._features(jg.elev[None], jg.valid[None], jnp.asarray(mf)[None])
    return np.asarray(model.apply({"params": jp}, x)), np.asarray(std)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_forward_pass_matches_jax(tiles, committed, compute):
    jg, tg, _, _ = tiles
    jp, tp, w, d = committed
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    mf = np.asarray(j_fill_window_mean(jg))
    np.testing.assert_array_equal(fill_window_mean(tg).numpy(), mf)
    want, std = _jax_residual(jp, jg, mf, w, d, jdt)
    x, _, tstd = tl._features(tg.elev[None], tg.valid[None], torch.from_numpy(mf.copy())[None])
    assert x.shape == (1, 3) + tg.shape
    got = tl._apply(tp, x, width=w, depth=d, compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (1,) + tg.shape
    np.testing.assert_allclose(tstd.numpy(), std, rtol=1e-6)
    if compute == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_TOL)

    # the whole fill: JAX's fill_learned is bf16; at f32 it is rebuilt
    # from the f32 residual
    out = tl.fill_learned(tg, tp, width=w, depth=d, compute_dtype=tdt).numpy()
    if compute == "bf16":
        ref = np.asarray(jl.fill_learned(jg, jp, width=w, depth=d))
        atol = BF16_TOL * float(std.max())
    else:
        pred = np.where(np.isnan(mf), np.nan, mf + std[0] * want[0])
        ref = np.where(np.asarray(jg.valid) > 0.5, np.asarray(jg.elev), pred)
        atol = 1e-5 * float(np.nanmax(np.abs(ref)))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=0, atol=atol)


def test_untrained_equals_window_mean_and_observed_cells_pass_through(tiles):
    _, tg, _, _ = tiles
    params = tl.init_params(torch.Generator().manual_seed(0), width=W_, depth=D_, device="cpu")
    assert torch.equal(params["head.weight"], torch.zeros(1, W_, 3, 3))
    assert params["stem.weight"].abs().max() > 0
    out = tl.fill_learned(tg, params, width=W_, depth=D_).numpy()
    mf = fill_window_mean(tg).numpy()
    v = tg.valid.numpy() > 0.5
    want = np.where(v, tg.elev.numpy(), mf)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
    np.testing.assert_allclose(out[~np.isnan(want)], want[~np.isnan(want)], atol=1e-5)
    np.testing.assert_array_equal(out[v], tg.elev.numpy()[v])


def test_init_draws_lecun_normal():
    params = tl.init_params(torch.Generator().manual_seed(1), width=64, depth=1, device="cpu")
    w = params["conv0a.weight"]
    std = (1.0 / (9 * 64)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.05  # the truncation's 0.8796 undone
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert all(float(params[f"{n}.bias"].abs().max()) == 0.0 for n in ("stem", "conv0a", "conv0b", "head"))
    again = tl.init_params(torch.Generator().manual_seed(1), width=64, depth=1, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_training_batches_draw_as_the_jax_package_does(tiles):
    _, tg, _, _ = tiles
    for n, tile in ((3, 32), (2, 48)):
        for a, b in zip(tl.make_training_batch(np.random.RandomState(7), n=n, tile=tile),
                        jl.make_training_batch(np.random.RandomState(7), n=n, tile=tile)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        ev, va = tg.elev.numpy(), tg.valid.numpy()
        for a, b in zip(tl.make_crop_batch(np.random.RandomState(7), ev, va, n=n, tile=tile),
                        jl.make_crop_batch(np.random.RandomState(7), ev, va, n=n, tile=tile)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_three_f32_adam_steps_match_optax():
    jp = jl.init_params(jax.random.PRNGKey(0), width=W_, depth=D_, tile=TILE)
    tp = convert.learned_params_from_arrays(_tree_to_numpy(jp), "cpu")
    for p in tp.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(tp.values()), lr=3e-3)
    tx = optax.adam(3e-3)
    state = tx.init(jp)
    model = jl.MaskedConvInpainter(width=W_, depth=D_, compute_dtype=jnp.float32)

    def jloss(params, e, v, mf, t, m):
        x, _, std = jl._features(e, v, mf)
        pred = mf + std * model.apply({"params": params}, x)
        ok = m * (~jnp.isnan(mf)).astype(jnp.float32)
        d = jnp.where(ok > 0, pred - t, 0.0)
        return jnp.sum(d * d) / jnp.maximum(jnp.sum(ok), 1.0)

    @jax.jit
    def jstep(params, state, *batch):
        loss, grads = jax.value_and_grad(jloss)(params, *batch)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    def jmean(e, v):
        return j_fill_window_mean(JGrid(elev=e, valid=v, min_lon=0.0, max_lon=TILE - 1.0, min_lat=0.0,
                                        max_lat=TILE - 1.0))

    rng = np.random.RandomState(1)
    for _ in range(3):
        e, v, t, m = tl.make_training_batch(rng, n=4, tile=TILE)
        mf = jax.vmap(jmean)(jnp.asarray(e), jnp.asarray(v))
        jp, state, jl_loss = jstep(jp, state, e, v, mf, t, m)
        te, tv, tt, tm = (torch.from_numpy(a) for a in (e, v, t, m))
        tmf = tl.window_mean_batch(te, tv)
        np.testing.assert_array_equal(tmf.numpy(), np.asarray(mf))
        tp, opt, tl_loss = tl.train_step(tp, opt, (te, tv, tmf, tt, tm), width=W_, depth=D_,
                                         compute_dtype=torch.float32)
        np.testing.assert_allclose(float(tl_loss), float(jl_loss), rtol=1e-4)
        want = convert.learned_params_from_arrays(_tree_to_numpy(jp), "cpu")
        for k in want:
            np.testing.assert_allclose(tp[k].detach().numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_training_reduces_the_masked_mse(tiles):
    jg, tg, rc, truth = tiles
    params, hist = tl.train(steps=60, width=W_, depth=D_, tile=TILE, batch=4, seed=1, device="cpu")
    assert len(hist) == 60 and hist[-1] < hist[0] * 0.7, (hist[0], hist[-1])
    out = tl.fill_learned(tg, params, width=W_, depth=D_).numpy()
    assert np.isfinite(out[rc[:, 0], rc[:, 1]]).all()


def test_checkpoints_round_trip_into_the_jax_package(tmp_path, tiles):
    jg, tg, _, _ = tiles
    params = tl.init_params(torch.Generator().manual_seed(5), width=W_, depth=D_, device="cpu")
    params["head.weight"] = torch.full_like(params["head.weight"], 0.01)
    path = str(tmp_path / "ckpt.npz")
    tl.save_params(path, params, width=W_, depth=D_)
    with np.load(path) as z:
        with np.load(CHECKPOINTS[0]) as ref:
            assert {k.split("/")[-1] for k in z.files} == {k.split("/")[-1] for k in ref.files}
        assert z["stem/kernel"].shape == (3, 3, 3, W_) and int(z["__width__"]) == W_
    jp, w, d = jl.load_params(path)
    assert (w, d) == (W_, D_)
    back = convert.learned_params_from_arrays(_tree_to_numpy(jp), "cpu")
    assert all(torch.equal(back[k], params[k]) for k in params)
    again, w2, d2 = tl.load_params(path, device="cpu")
    assert (w2, d2) == (W_, D_) and all(torch.equal(again[k], params[k]) for k in params)
    np.testing.assert_array_equal(tl.fill_learned(tg, again, width=w2, depth=d2).numpy(),
                                  tl.fill_learned(tg, params, width=W_, depth=D_).numpy())
