"""Learned interpolation: a masked-convolution inpainting baseline
(counterpart of :mod:`auvtpu.learned`).

A small residual CNN fills masked bathymetry grids on top of the window-mean
fill: it predicts a *residual* against :func:`~auvtpu_torch.ops.fill_window_mean`
from (normalised elev * valid, valid, normalised mean fill), so an untrained
network (zero head) IS the classical baseline.  Per-tile normalisation by the
observed cells' mean and std lets one set of weights serve tiles of any
depth scale.

The network is the JAX package's flax module, layer for layer: 3x3
convolutions with SAME padding (``padding=1``), tanh-approximate GELU, a
zero-initialised head, and flax's mixed precision made explicit: input,
kernels and biases cast to ``compute_dtype`` (bfloat16 by default), the
convolution, bias add, GELU and residual sums in that dtype, the output
returned as float32.  Features are NCHW with the channel order
``[normed, valid, mean_fill]``.

Parameters are a ``state_dict`` of float32 tensors (OIHW kernels).
Checkpoints are the JAX package's npz format, flax key names
(``conv0a/kernel``) with HWIO kernels and ``__width__``/``__depth__``, so
one file loads in both packages.  The window-mean baseline runs the B3
kernel (``fill_tile_kernel<kMean>``) on a CUDA float32 grid, one launch a
grid or training tile.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import Extent
from .convert import learned_params_from_arrays
from .grid import RegularGrid, device_cache
from .ops import fill_window_mean


def learned_available() -> bool:
    """Whether the learned baseline can run.  The JAX package's checks that
    flax and optax import; this module needs only ``torch.nn`` and
    ``torch.optim``, which it has imported already, so it is always true."""
    return True


class MaskedConvInpainter(nn.Module):
    """Small residual CNN: (normed elev*valid, valid, normed mean fill), NCHW
    -> residual (B, H, W) float32."""

    def __init__(self, width: int = 32, depth: int = 4, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depth = depth
        self.compute_dtype = compute_dtype
        self.stem = nn.Conv2d(3, width, 3, padding=1)
        for i in range(depth):
            self.add_module(f"conv{i}a", nn.Conv2d(width, width, 3, padding=1))
            self.add_module(f"conv{i}b", nn.Conv2d(width, width, 3, padding=1))
        self.head = nn.Conv2d(width, 1, 3, padding=1)

    def _conv(self, name: str, h):
        """flax's ``nn.Conv(dtype=...)``: kernel and bias cast to the compute
        dtype, the convolution, then the bias added in that dtype."""
        conv = getattr(self, name)
        dt = self.compute_dtype
        return F.conv2d(h, conv.weight.to(dt), padding=1) + conv.bias.to(dt)[:, None, None]

    def forward(self, x):
        h = F.gelu(self._conv("stem", x.to(self.compute_dtype)), approximate="tanh")
        for i in range(self.depth):
            r = F.gelu(self._conv(f"conv{i}a", h), approximate="tanh")
            h = h + self._conv(f"conv{i}b", r)
        return self._conv("head", h)[:, 0].float()


def _apply(params: dict, x, *, width: int, depth: int, compute_dtype):
    """The inpainter with parameters ``params`` on features ``x``."""
    model = _skeleton(width, depth, compute_dtype)
    return torch.func.functional_call(model, params, (x,))


@device_cache(maxsize=16)
def _skeleton(width: int, depth: int, compute_dtype):
    """A module without storage (meta device) to call with given parameters."""
    with torch.device("meta"):
        return MaskedConvInpainter(width, depth, compute_dtype)


def _normalize(elev, valid):
    """Observed-cell mean/std per tile; returns (normed*valid, mean, std)."""
    cnt = torch.clamp(valid.sum(dim=(-2, -1), keepdim=True), min=1.0)
    mean = (elev * valid).sum(dim=(-2, -1), keepdim=True) / cnt
    var = (((elev - mean) * valid) ** 2).sum(dim=(-2, -1), keepdim=True) / cnt
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    return (elev - mean) / std * valid, mean, std


def _features(elev, valid, mean_fill):
    """(B, 3, H, W) network input from batched (B, H, W) planes (the mean
    fill normalised with the same per-tile statistics)."""
    normed, mean, std = _normalize(elev, valid)
    mf = torch.where(torch.isnan(mean_fill), 0.0, (mean_fill - mean) / std)
    return torch.stack([normed, valid, mf], dim=1), mean, std


def init_params(generator: torch.Generator, *, width: int = 32, depth: int = 4, device="cuda") -> dict:
    """Fresh parameters drawn as flax draws them, from ``generator`` (a CPU
    generator; JAX's PRNG is not reproduced): kernels lecun-normal
    (truncated normal, fan-in scaling), biases zero, the head zero."""
    params = {}
    for name, cin, cout in [("stem", 3, width)] + [
        (f"conv{i}{s}", width, width) for i in range(depth) for s in "ab"
    ] + [("head", width, 1)]:
        w = torch.zeros((cout, cin, 3, 3), dtype=torch.float32)
        if name != "head":
            # jax.nn.initializers.lecun_normal: stddev sqrt(1/fan_in) / .8796
            # (the std of a unit normal truncated to [-2, 2])
            std = (1.0 / (9 * cin)) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        params[f"{name}.weight"] = w.to(device)
        params[f"{name}.bias"] = torch.zeros(cout, dtype=torch.float32, device=device)
    return params


@torch.no_grad()
def predict_planes(params: dict, elev, valid, mean_fill, *, width: int = 32, depth: int = 4,
                   compute_dtype=torch.bfloat16):
    """Batched fill planes from batched (B, H, W) (elev, valid, mean_fill).

    Returns the denormalised prediction: mean_fill + std * residual, with
    observed cells passed through and cells where even the mean fill failed
    (no neighbours) left NaN.
    """
    x, mean, std = _features(elev, valid, mean_fill)
    res = _apply(params, x, width=width, depth=depth, compute_dtype=compute_dtype)
    pred = mean_fill + std * res  # std (B,1,1) broadcasts over (B,H,W)
    pred = torch.where(torch.isnan(mean_fill), torch.nan, pred)
    return torch.where(valid > 0.5, elev, pred)


def fill_learned(grid: RegularGrid, params: dict, *, width: int = 32, depth: int = 4,
                 convention: str = "reference", compute_dtype=torch.bfloat16):
    """Single-grid learned fill (API twin of ops.fill_*): observed cells keep
    their values, gaps get the CNN prediction, unreachable cells stay NaN.

    ``convention`` picks the window-mean baseline the residual corrects
    (training and serving must use the same one)."""
    mf = fill_window_mean(grid, convention=convention)
    out = predict_planes(params, grid.elev[None], grid.valid[None], mf[None], width=width, depth=depth,
                         compute_dtype=compute_dtype)
    return out[0]


def _loss_fn(params: dict, elev, valid, mean_fill, target, tmask, *, width: int, depth: int,
             compute_dtype=torch.bfloat16):
    x, mean, std = _features(elev, valid, mean_fill)
    res = _apply(params, x, width=width, depth=depth, compute_dtype=compute_dtype)
    pred = mean_fill + std * res
    ok = tmask * (~torch.isnan(mean_fill)).float()
    d = torch.where(ok > 0, pred - target, 0.0)
    return torch.sum(d * d) / torch.clamp(torch.sum(ok), min=1.0)


def train_step(params: dict, opt: torch.optim.Optimizer, batch, *, width: int = 32, depth: int = 4,
               compute_dtype=torch.bfloat16):
    """One Adam step on held-out-cell MSE; ``opt`` holds ``params``' tensors
    (torch.optim.Adam is optax.adam's update).  batch = (elev, valid,
    mean_fill, target, tmask): target/tmask are the artificially masked
    cells whose true values are known.  Returns (params, opt, loss)."""
    opt.zero_grad(set_to_none=True)
    loss = _loss_fn(params, *batch, width=width, depth=depth, compute_dtype=compute_dtype)
    loss.backward()
    opt.step()
    return params, opt, loss.detach()


def make_training_batch(rng: np.random.RandomState, *, n: int = 8, tile: int = 64, removal=(0.05, 0.3)):
    """Self-supervised batch from synthetic tiles: mask a fraction of the
    observed cells, train to recover them.  Returns numpy planes (the JAX
    package's draws from the same ``rng``)."""
    from .synthetic import shelf_seamount

    elevs, valids, targets, tmasks = [], [], [], []
    for _ in range(n):
        base = shelf_seamount(
            tile, tile,
            k=float(rng.uniform(0.5, 4.0)),
            amplitude=float(rng.uniform(30.0, 200.0)),
            center_x=float(rng.uniform(15.0, 85.0)),
            center_y=float(rng.uniform(15.0, 85.0)),
            sigma_x=float(rng.uniform(8.0, 25.0)),
            sigma_y=float(rng.uniform(8.0, 25.0)),
        )
        frac = float(rng.uniform(*removal))
        m = rng.rand(tile, tile) < frac
        elevs.append(np.where(m, 0.0, base).astype(np.float32))
        valids.append((~m).astype(np.float32))
        targets.append(base.astype(np.float32))
        tmasks.append(m.astype(np.float32))
    return np.stack(elevs), np.stack(valids), np.stack(targets), np.stack(tmasks)


def make_crop_batch(rng: np.random.RandomState, elev_plane, valid_plane, *, n: int = 8, tile: int = 64,
                    hide=(0.05, 0.3)):
    """Self-supervised batch from a REAL reduced tile: random crops with a
    further fraction of the observed cells hidden as training targets."""
    H, W = elev_plane.shape
    elevs, valids, targets, tmasks = [], [], [], []
    for _ in range(n):
        r = rng.randint(0, H - tile + 1)
        c = rng.randint(0, W - tile + 1)
        e = elev_plane[r: r + tile, c: c + tile]
        v = valid_plane[r: r + tile, c: c + tile]
        frac = float(rng.uniform(*hide))
        hidem = (rng.rand(tile, tile) < frac) & (v > 0.5)
        valids.append((v > 0.5) & ~hidem)
        elevs.append(np.where(hidem, 0.0, e))
        targets.append(e)
        tmasks.append(hidem)
    return tuple(np.stack(a).astype(np.float32) for a in (elevs, valids, targets, tmasks))


def window_mean_batch(elev, valid, *, convention: str = "reference"):
    """The window-mean baseline of each (H, W) tile of a (B, H, W) batch on
    a unit-step extent: one :func:`fill_window_mean` call (one B3 launch on
    a CUDA float32 batch) a tile."""
    tile_h, tile_w = elev.shape[-2:]
    ext = Extent(0.0, float(tile_w - 1), 0.0, float(tile_h - 1))
    return torch.stack([
        fill_window_mean(RegularGrid(elev=e, valid=v, min_lon=ext.min_lon, max_lon=ext.max_lon,
                                     min_lat=ext.min_lat, max_lat=ext.max_lat), convention=convention)
        for e, v in zip(elev, valid)
    ])


def train(steps: int = 200, *, width: int = 32, depth: int = 4, tile: int = 64, batch: int = 8, lr: float = 3e-3,
          seed: int = 0, log_every: int = 0, log=print, batch_fn=None, convention: str = "reference",
          compute_dtype=torch.bfloat16, device="cuda"):
    """Train the inpainter; returns (params, loss_history).

    Default batches are synthetic tiles (make_training_batch); pass
    batch_fn(rng) -> (elev, valid, target, tmask) to train on real data
    (see make_crop_batch).  Parameters start from :func:`init_params` with a
    generator seeded by ``seed``."""
    rng = np.random.RandomState(seed)
    params = init_params(torch.Generator().manual_seed(seed), width=width, depth=depth, device=device)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    hist = []
    for s in range(steps):
        if batch_fn is not None:
            planes = batch_fn(rng)
        else:
            planes = make_training_batch(rng, n=batch, tile=tile)
        elev, valid, target, tmask = (torch.as_tensor(a).to(device) for a in planes)
        mf = window_mean_batch(elev, valid, convention=convention)
        params, opt, loss = train_step(params, opt, (elev, valid, mf, target, tmask), width=width, depth=depth,
                                       compute_dtype=compute_dtype)
        hist.append(float(loss))
        if log_every and (s % log_every == 0):
            log(f"step {s}: masked-cell MSE {hist[-1]:.4f}")
    return params, hist


# --------------------------------------------------------------------------
# parameter checkpointing (npz, the JAX package's format)
# --------------------------------------------------------------------------

def save_params(path: str, params: dict, *, width: int, depth: int) -> None:
    """Flat-key npz checkpoint in the JAX package's format: flax key names
    (``stem/kernel``, ``conv0a/bias``), HWIO kernels, and the architecture
    (``__width__``, ``__depth__``)."""
    arrs = {}
    for key, t in params.items():
        name, kind = key.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if kind == "weight":
            arrs[f"{name}/kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        else:
            arrs[f"{name}/bias"] = a
    arrs["__width__"] = np.asarray(width)
    arrs["__depth__"] = np.asarray(depth)
    np.savez_compressed(path, **arrs)


def load_params(path: str, device="cuda"):
    """Returns (params, width, depth) from a checkpoint of either package."""
    with np.load(path) as d:
        width = int(d["__width__"])
        depth = int(d["__depth__"])
        params = learned_params_from_arrays({k: d[k] for k in d.files if not k.startswith("__")}, device=device)
    want = {k: tuple(v.shape) for k, v in _skeleton(width, depth, torch.float32).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != want:
        raise ValueError(f"{path}: parameters {got} do not make a width {width}, depth {depth} inpainter {want}")
    return params, width, depth
