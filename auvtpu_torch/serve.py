"""Ahead-of-time export for production serving (counterpart of
:mod:`auvtpu.serve`).

The reference ships compiled binaries that embed their kernels; the JAX
package writes serialized StableHLO.  Here an artifact is a
``torch.export`` program (``torch.export.save``, a ``.pt2`` file): the fill
is traced once, and serving runs the recorded graph with no Python of the
fill in the path.  The CUDA kernels are ``torch.library`` custom ops
(:mod:`auvtpu_torch.kernels.library`), so the graph holds them as
``auvtpu_torch::`` nodes and the loaded program launches them::

    export_fill("fill.pt2", (2053, 2441), method="kriging")
    ...
    srv = load_exported("fill.pt2")
    plane = srv(elev, valid)      # elev/valid (H, W) f32 on the artifact's device

Shapes are static: export one artifact per tile geometry (and query batch
size).  An artifact is for one device, ``device`` at export (the card by
default), and its loader raises on an input that lies elsewhere: it never
moves data.  On the card the fills reach the kernels (B1, B3, B8) and the
scattered engine B12 (kriging) or B15 (IDW);
on the CPU the same ops run their plain versions.  The plain whole-plane
paths cannot be traced (they read counts back to stop their scans early),
so no artifact holds one.  Each artifact carries its metadata as an extra
file (``auvtpu_torch.json``): the port's version, the device, the backend
and the custom ops it holds.
"""

from __future__ import annotations

import json
import os

import torch

from . import __version__
from .grid import RegularGrid
from .kernels import library

META = "auvtpu_torch.json"


class _Program(torch.nn.Module):
    """The traced function as a module (``torch.export`` takes modules).
    Tensors the function closes over become constants of the program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _backend(backend: str, device: torch.device) -> str:
    """The fill route an artifact holds: the kernels' ops ("fused").  On the
    CPU their implementation is the plain version, so "torch" is that route
    too; on the card a plain path would hide the kernel and is refused."""
    if backend in ("auto", "fused") or (backend == "torch" and device.type == "cpu"):
        return "fused"
    raise ValueError(f"backend {backend!r} cannot be exported on {device}: an artifact holds the kernels' ops "
                     "(backend 'auto' or 'fused')")


def ops_in(program) -> list[str]:
    """The ``auvtpu_torch::`` custom ops a traced program holds."""
    return sorted({
        n.target._schema.name for n in program.graph.nodes
        if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
        and n.target.namespace == library.NAMESPACE
    })


def _export_artifact(path: str, fn, specs, device: torch.device, **meta) -> int:
    """Shared export tail: trace ``fn`` at example inputs of the given
    (shape, ...) specs on ``device``, save the program with its metadata,
    return the byte size written."""
    args = tuple(torch.zeros(s, dtype=torch.float32, device=device) for s in specs)
    with torch.no_grad():  # serving computes no gradient (and the learned fill's no_grad is then no region)
        program = torch.export.export(_Program(fn), args, strict=False)
    program.example_inputs = None  # the zeros traced with: a grid's worth of bytes the artifact need not carry
    meta = dict(version=__version__, device=str(device), ops=ops_in(program), **meta)
    torch.export.save(program, path, extra_files={META: json.dumps(meta)})
    return os.path.getsize(path)


def read_meta(path: str) -> dict:
    """The metadata an artifact carries."""
    extra = {META: ""}
    torch.export.load(path, extra_files=extra)
    return json.loads(extra[META])


def _loaded(path: str):
    """An artifact as a callable that takes float32 inputs on the
    artifact's device (numpy arrays count as on the CPU) and raises on any
    other device."""
    extra = {META: ""}
    module = torch.export.load(path, extra_files=extra).module()
    meta = json.loads(extra[META])
    dev = torch.device(meta["device"])
    if dev.type == "cuda":
        # the recorded matrix products and convolutions run at full f32
        # precision, as the live path runs them (TF32 keeps ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def call(*args):
        ts = []
        for a in args:
            t = torch.as_tensor(a)
            if t.device != dev:
                raise ValueError(f"{os.path.basename(path)} was exported for {dev}, an input lies on {t.device}; "
                                 "the artifact does not move its inputs")
            ts.append(t.to(torch.float32))
        return module(*ts)

    return call


def _grid(elev, valid, extent) -> RegularGrid:
    min_lon, max_lon, min_lat, max_lat = extent
    return RegularGrid(elev=elev, valid=valid, min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat)


def _vario(vparams, device: torch.device):
    """The variogram as one (3,) tensor made before the trace (None: the
    reference's fixed model), a constant of the program."""
    return library.variogram_tensor(vparams, torch.empty(0, dtype=torch.float32, device=device)).clone()


# ---------------------------------------------------------------------------
# dense fills
# ---------------------------------------------------------------------------

def _fill_fn(extent, method, max_radius, vario, convention):
    from .ops import fill_idw, fill_kriging, fill_window_mean

    def fill(elev, valid):
        g = _grid(elev, valid, extent)
        if method == "kriging":
            return fill_kriging(g, max_radius=max_radius, vparams=vario, convention=convention, backend="fused")
        if method == "idw":
            return fill_idw(g, max_radius=max_radius, convention=convention, backend="fused")
        if method == "window_mean":
            return fill_window_mean(g, max_radius=max_radius, convention=convention, backend="fused")
        raise ValueError(method)

    return fill


def export_fill(path: str, shape, *, extent=(0.0, 1.0, 0.0, 1.0), method: str = "kriging", max_radius: int = 10, vparams=None, convention: str = "reference", backend: str = "auto", device="cuda"):
    """Write the dense fill for a fixed grid geometry to ``path``:
    ``fill(elev, valid) -> plane`` (B1 for kriging, B3 for idw and
    window_mean).  Returns the byte size written."""
    dev = _device(device)
    resolved = _backend(backend, dev)
    vario = _vario(vparams, dev) if method == "kriging" else None
    fill = _fill_fn(tuple(extent), method, max_radius, vario, convention)
    return _export_artifact(path, fill, (tuple(shape),) * 2, dev, kind="fill", method=method, backend=resolved)


def load_exported(path: str):
    """An :func:`export_fill` or :func:`export_learned` artifact as
    ``fill(elev, valid) -> plane``."""
    return _loaded(path)


# ---------------------------------------------------------------------------
# scattered serving from a stencil pack (B12, B15: B7's selection with the
# kriging solve or the IDW quotient)
# ---------------------------------------------------------------------------

def _scattered_fn(extent, method, window_radius, vparams, convention, k, power):
    from .kernels.scattered_select import packed_idw_fused, packed_kriging_fused

    def run(pack, elev, valid, lons, lats):
        g = _grid(elev, valid, extent)
        if method == "kriging":
            return packed_kriging_fused(pack, g, lons, lats, window_radius=window_radius, vparams=vparams,
                                        convention=convention)
        if method == "idw":
            return packed_idw_fused(pack, g, lons, lats, k=k, power=power, window_radius=window_radius,
                                    convention=convention)
        raise ValueError(method)

    return run


def export_scattered(path: str, shape, n_queries: int, *, extent=(0.0, 1.0, 0.0, 1.0), method: str = "kriging", window_radius: int = 2, vparams=None, convention: str = "reference", k: int = 8, power: float = 2.0, device="cuda"):
    """Write the packed scattered-query engine (B7's selection with the
    kriging solve, B12, or the IDW quotient, B15, in one op) for a fixed
    grid geometry and batch size: ``run(pack, elev, valid, lons, lats) ->
    preds``.  The stencil pack is an argument (build it once per grid with
    ``ops.packs.StencilPack``; ``.window`` is the flat (H*W*P,) layout), so
    the artifact stays small.  Returns the byte size written."""
    from .ops.packs import pack_width, window_offsets

    H, W = shape
    P = pack_width(len(window_offsets(window_radius)))
    dev = _device(device)
    run = _scattered_fn(tuple(extent), method, window_radius, vparams, convention, k, power)
    return _export_artifact(path, run, ((H * W * P,), (H, W), (H, W), (n_queries,), (n_queries,)), dev,
                            kind="scattered", method=method, backend="fused")


def load_exported_scattered(path: str):
    """An :func:`export_scattered` artifact as ``run(pack, elev, valid,
    lons, lats) -> preds``."""
    return _loaded(path)


# ---------------------------------------------------------------------------
# the learned fill
# ---------------------------------------------------------------------------

def export_learned(path: str, shape, params, *, extent=(0.0, 1.0, 0.0, 1.0), width: int = 16, depth: int = 2, convention: str = "reference", compute_dtype=torch.bfloat16, device="cuda"):
    """Write the learned fill (:func:`auvtpu_torch.learned.fill_learned`)
    with ``params`` (a port ``state_dict``, as ``learned.load_params`` gives
    it) embedded as constants: ``fill(elev, valid) -> plane``.  One artifact
    holds the architecture, the weights and the program; its window-mean
    baseline is B3.  Returns the byte size written."""
    from .learned import predict_planes
    from .ops import fill_window_mean

    dev = _device(device)
    params = {name: torch.as_tensor(t).detach().to(dev, torch.float32).clone() for name, t in params.items()}

    def fill(elev, valid):
        g = _grid(elev, valid, extent)
        mf = fill_window_mean(g, convention=convention, backend="fused")
        return predict_planes(params, g.elev[None], g.valid[None], mf[None], width=width, depth=depth,
                              compute_dtype=compute_dtype)[0]

    return _export_artifact(path, fill, (tuple(shape),) * 2, dev, kind="learned", backend="fused", width=width,
                            depth=depth, compute_dtype=str(compute_dtype))


# ---------------------------------------------------------------------------
# mission serving: the K-page fill and the chunked resample (B1/B3, B8)
# ---------------------------------------------------------------------------

def export_mission_fill(path: str, shape, placed, pr: int, pc: int, *, extent=(0.0, 1.0, 0.0, 1.0), method: str = "kriging", margin: int = 10, fill_backend: str = "auto", convention: str = "reference", model: str = "exponential", device="cuda"):
    """Write the K-page band/atlas fill for a fixed grid geometry and page
    placement: ``fill(elev, valid) -> (planes, vmasks)``.  ``placed`` is
    the tuple of (row0, col0) page origins (``BandAtlas.placed``, or one
    pair for a band); pages share the (pr, pc) shape.  This is the serving
    refresh of ``ops.band.BandRouter`` (the masked flag pinned, as its
    refresh pins it).  Returns the byte size written."""
    from .ops.band import _fill_pages

    dev = _device(device)
    resolved = _backend(fill_backend, dev)
    placed = tuple((int(r), int(c)) for r, c in placed)
    vario = _vario(None, dev) if method == "kriging" else None

    def fill(elev, valid):
        return _fill_pages(_grid(elev, valid, tuple(extent)), vario, placed=placed, pr=int(pr), pc=int(pc),
                           method=method, margin=margin, fill_backend=resolved, convention=convention, model=model)

    return _export_artifact(path, fill, (tuple(shape),) * 2, dev, kind="mission_fill", method=method,
                            backend=resolved, placed=placed, page=[int(pr), int(pc)])


def export_mission_resample(path: str, shape, placed, pr: int, pc: int, n_queries: int, *, extent=(0.0, 1.0, 0.0, 1.0), chunk: int = 512, win_rows: int = 48, win_cols: int = 128, masked: bool = False, lerp_mode: str = "hat_t", device="cuda"):
    """Write the chunked windowed-bilinear resample (B8) over a K-page atlas
    for a fixed page placement and batch size: ``run(planes, vmasks, lons,
    lats) -> (z, resolved)``.  Unresolved queries (a page straddle, an
    undefined cell) return NaN and False and escalate to the exported
    scattered engine, the live BandRouter's two tiers.  The resample is the
    live resampler's: the chunk clamped to the batch, ``lerp_mode`` the
    router's weights (default its 'hat_t'), one page served as a band.
    ``masked`` is frozen into the artifact: True for a production refresh
    loop (always correct: the vmask rides along), False only if every
    refresh provably resolves all page cells.  Returns the byte size
    written."""
    from .ops.band import _affine, _atlas_resample, _effective_chunk

    dev = _device(device)
    placed = tuple((int(r), int(c)) for r, c in placed)
    one = len(placed) == 1
    # one page is a band at (row0, col0): the shift is in the prologue, as
    # BandResampler serves it; pages are picked by their origins
    frame = torch.empty(tuple(shape), device="meta")
    affine = _affine(_grid(frame, frame, tuple(extent)), *(placed[0][::-1] if one else (0, 0)))
    origins = None if one else torch.tensor(placed, dtype=torch.float32, device=dev)
    kw = dict(chunk=_effective_chunk(int(n_queries), int(chunk)), wr=min(int(win_rows), int(pr)),
              wc=min(int(win_cols), int(pc)), masked=bool(masked), pick=not one, lerp_mode=lerp_mode)

    def run(planes, vmasks, lons, lats):
        return _atlas_resample(planes, vmasks, origins, lons, lats, affine=affine, **kw)

    pages = (len(placed), int(pr), int(pc))
    return _export_artifact(path, run, (pages, pages, (int(n_queries),), (int(n_queries),)), dev,
                            kind="mission_resample", backend="fused", placed=placed, **kw)


def load_exported_mission(fill_path: str, resample_path: str):
    """An :func:`export_mission_fill` / :func:`export_mission_resample` pair
    as ``(fill(elev, valid) -> (planes, vmasks), run(planes, vmasks, lons,
    lats) -> (z, resolved))``."""
    return _loaded(fill_path), _loaded(resample_path)

