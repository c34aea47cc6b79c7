"""Point-splat renderer: JAX rasterizer -> PNG frames -> animated GIF.

Replaces the reference's Qt/OpenGL immediate-mode viewer
(/root/reference/src/visualization.cpp): additive-blended grey points over a
black background, camera looking down the y axis of the box (the disk plane is
x-z, src/sph.cpp:379).  The splat is computed on-device as a scatter-add into
the image grid — the same trick as the voxel binning — so rendering 1M
particles is one fused XLA program.

PIL is used for encoding when present; otherwise a dependency-free PNG encoder
(zlib) is used and GIFs fall back to a PNG frame directory.
"""

from __future__ import annotations

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SphConfig
from ..state import ParticleState

try:  # pillow ships with the baked-in torch/transformers stack
    from PIL import Image

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


from functools import partial


@partial(jax.jit, static_argnames=("size",))
def _splat(pos_xy: jnp.ndarray, extent: jnp.ndarray, size: int = 512,
           gain: float = 40.0) -> jnp.ndarray:
    """Additive point splat of [N,2] coords into a [size,size] u8 image."""
    uv = pos_xy / extent  # [0,1]^2
    pix = jnp.clip((uv * size).astype(jnp.int32), 0, size - 1)
    flat = pix[:, 1] * size + pix[:, 0]
    counts = jnp.zeros((size * size,), jnp.float32).at[flat].add(1.0)
    img = jnp.clip(counts * gain, 0.0, 255.0).astype(jnp.uint8)
    return img.reshape(size, size)


@partial(jax.jit, static_argnames=("size",))
def _splat_perspective(pos: jnp.ndarray, eye: jnp.ndarray, target: jnp.ndarray,
                       size: int = 512, gain: float = 40.0,
                       tan_half_fov: float = 0.5) -> jnp.ndarray:
    """Perspective point splat: lookAt basis + frustum divide, like the
    reference's gluPerspective/lookAt camera (visualization.cpp:327-362)."""
    def norm(v):
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-12)

    fwd = norm(target - eye)
    world_up = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    right = norm(jnp.cross(fwd, world_up))
    up = jnp.cross(right, fwd)
    rel = pos - eye
    xc = rel @ right
    yc = rel @ up
    zc = rel @ fwd
    near = jnp.float32(1e-3)
    zc_safe = jnp.maximum(zc, near)
    u = xc / (zc_safe * tan_half_fov)          # [-1,1] at the fov edge
    v = yc / (zc_safe * tan_half_fov)
    visible = (zc > near) & (jnp.abs(u) < 1.0) & (jnp.abs(v) < 1.0)
    px = jnp.clip(((u * 0.5 + 0.5) * size).astype(jnp.int32), 0, size - 1)
    py = jnp.clip(((0.5 - v * 0.5) * size).astype(jnp.int32), 0, size - 1)
    flat = jnp.where(visible, py * size + px, 0)
    w = visible.astype(jnp.float32)
    counts = jnp.zeros((size * size,), jnp.float32).at[flat].add(w)
    img = jnp.clip(counts * gain, 0.0, 255.0).astype(jnp.uint8)
    return img.reshape(size, size)


def _box_edge_points(cfg: SphConfig, samples: int = 192) -> np.ndarray:
    """[12*samples, 3] points along the simulation box's 12 edges."""
    bx, by, bz = (float(v) for v in cfg.box_max)
    corners = np.asarray([[x, y, z] for x in (0.0, bx) for y in (0.0, by)
                          for z in (0.0, bz)], np.float32)
    edges = [(a, b) for a in range(8) for b in range(a + 1, 8)
             if sum(corners[a] != corners[b]) == 1]
    t = np.linspace(0.0, 1.0, samples, dtype=np.float32)[:, None]
    return np.concatenate([corners[a] * (1 - t) + corners[b] * t
                           for a, b in edges], axis=0)


def render_frame_perspective(cfg: SphConfig, state: ParticleState,
                             size: int = 512, gain: float = 40.0,
                             elevation: float = 0.45,
                             distance: float = 1.6,
                             azimuth: float = 180.0,
                             box: bool = True) -> np.ndarray:
    """3-D perspective view: camera orbit-style around the box, looking at its
    center — the analog of the reference's GL frustum + lookAt camera
    normalized by box size (visualization.cpp:327-362).

    ``azimuth`` (degrees, orbit around the +y axis; 180 = the legacy -z view),
    ``elevation`` (camera height as a fraction of the box span) and
    ``distance`` (eye distance in box spans) are the view controls; ``box``
    overlays the wireframe box outline the reference always draws
    (visualization.cpp:64-134, alpha 0.2)."""
    box_max = jnp.asarray(cfg.box_max, jnp.float32)
    center = box_max * 0.5
    span = float(jnp.max(box_max))
    az = float(np.deg2rad(azimuth))
    eye = center + jnp.asarray(
        [distance * span * np.sin(az), elevation * span,
         distance * span * np.cos(az)], jnp.float32)
    img = np.asarray(_splat_perspective(
        state.position, eye, center, size=size, gain=gain))
    if not box:
        return img
    # wireframe overlay: splat dense samples of the 12 edges through the SAME
    # camera; alpha-0.2-grey analog = a dim fixed shade, particles on top
    edge = np.asarray(_splat_perspective(
        jnp.asarray(_box_edge_points(cfg)), eye, center, size=size,
        gain=255.0))
    return np.maximum(img, np.minimum(edge, np.uint8(64)))


def render_frame(cfg: SphConfig, state: ParticleState, size: int = 512,
                 axis: str = "xz", gain: float = 40.0,
                 voxels: bool = False) -> np.ndarray:
    """Render one frame of the particle cloud.

    Greyscale [size,size] u8 by default (the reference's additive point
    blending, visualization.cpp:137-163); with ``voxels=True`` returns RGB
    [size,size,3] with occupied grid cells shaded red at intensity
    proportional to their occupancy — the reference's drawVoxels overlay
    (visualization.cpp:166-213, intensity 0.02*count).
    """
    ax = {"x": 0, "y": 1, "z": 2}
    a, b = ax[axis[0]], ax[axis[1]]
    box = cfg.box_max
    pos = state.position[:, jnp.asarray([a, b])]
    extent = jnp.asarray([box[a], box[b]], jnp.float32)
    grey = np.asarray(_splat(pos, extent, size=size, gain=gain))
    if not voxels:
        return grey
    # cell occupancy projected along the remaining axis
    from ..ops.grid import cell_coords

    dims = {0: cfg.grid_nx, 1: cfg.grid_ny, 2: cfg.grid_nz}
    coords = cell_coords(cfg, state.position)
    flat = coords[:, a] * dims[b] + coords[:, b]
    counts = jnp.zeros((dims[a] * dims[b],), jnp.float32).at[flat].add(1.0)
    vox = np.asarray(jnp.clip(counts * (0.02 * 255.0), 0, 255.0)
                     .reshape(dims[a], dims[b]).astype(jnp.uint8))
    # upsample nearest to image size
    reps = (size // vox.shape[0] + 1, size // vox.shape[1] + 1)
    vox_img = np.kron(vox, np.ones(reps, np.uint8))[:size, :size]
    rgb = np.stack([np.maximum(grey, vox_img), grey, grey], axis=-1)
    return rgb


def ansi_frame(img: np.ndarray, cols: int = 80, rows: int = 24) -> str:
    """Greyscale image -> ANSI half-block string: the in-terminal live view.

    The reference repaints its GL pane at 60 FPS while the sim runs
    (reference src/visualization.cpp:24-33); on a headless host the
    terminal IS the display, so each character cell renders two vertically
    stacked pixels with the upper-half-block glyph (foreground = top pixel,
    background = bottom pixel) on the 24-level xterm-256 greyscale ramp.
    Downsampling is block-max so sparse splats stay visible at 80x24.
    """
    if img.ndim == 3:
        img = img.max(axis=-1)
    h, w = img.shape
    ph, pw = rows * 2, cols
    # block-max pool onto a (2*rows, cols) pixel grid
    ys = np.minimum((np.arange(ph + 1) * h) // ph, h)
    xs = np.minimum((np.arange(pw + 1) * w) // pw, w)
    pix = np.zeros((ph, pw), np.uint8)
    for r in range(ph):
        row = img[ys[r]:max(ys[r + 1], ys[r] + 1)]
        seg = np.maximum.reduceat(row.max(axis=0), xs[:-1])
        pix[r] = seg
    # xterm-256 greyscale ramp: 232 (near black) .. 255 (near white)
    shade = 232 + (pix.astype(np.int32) * 24) // 256
    out = []
    for r in range(rows):
        line = []
        for c in range(cols):
            line.append(f"\x1b[38;5;{shade[2 * r, c]}m"
                        f"\x1b[48;5;{shade[2 * r + 1, c]}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def save_png(img: np.ndarray, path: str) -> None:
    if _HAVE_PIL:
        Image.fromarray(img, mode="L" if img.ndim == 2 else "RGB").save(path)
        return
    if img.ndim == 3:
        img = img.max(axis=-1)
    _write_png_gray(img, path)


def save_gif(frames: list[np.ndarray], path: str, duration_ms: int = 50) -> None:
    """Animated GIF like the reference README's sph_anim.gif."""
    if _HAVE_PIL:
        imgs = [Image.fromarray(f, mode="L").convert("P") for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=duration_ms, loop=0)
        return
    # Fallback: dump numbered PNGs next to the requested path.
    stem, _ = os.path.splitext(path)
    os.makedirs(stem, exist_ok=True)
    for i, f in enumerate(frames):
        _write_png_gray(f, f"{stem}/frame_{i:05d}.png")


def _write_png_gray(img: np.ndarray, path: str) -> None:
    """Minimal dependency-free 8-bit greyscale PNG encoder."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
