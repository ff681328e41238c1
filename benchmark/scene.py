"""The benchmark's scene generator: a seeded car-rear clip rendered on the card.

A planar car rear carrying a license plate recedes from a static camera at a
known speed while drifting sideways, over a smooth low-contrast background.
Every textured point lies on the car's plane, the camera does not move and
the car does not rotate, so the plate-anchored pipeline can recover the
motion up to tracking noise, and the scene knows the answer: the plane's
homography into every frame, the car's position in the camera frame, its
speed, and the plate's corners in frame 0.

The geometry comes from a configuration's ``scene`` (sizes, focal, principal
point, speed, depth, pose, stride); seeds draw only the car's paint and the
sensor noise, so every seed gives the same sizes and motion. Rendering
is torch on ``device`` with a ``torch.Generator`` there; the frames come back
to the host as one uint8 array. This module imports nothing of the program.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np
import torch

# the car's paint: blocky parts with sharp-ish corners over a mid-grey
PAINT_BLOCKS = 420
BLOCK_SIZE = (5, 26)  # texels, [low, high)
PAINT_LEVELS = (25.0, 215.0)
BASE_LEVEL = 105.0
TEXTURE_BLUR = 0.8  # texels
PLATE_MARGIN_M = 0.012  # the dark holder around the plate
CHARACTERS = 6
BANK = 0  # the set of clips that runs draw their pools from


@dataclass
class Truth:
    """What the scene knows, float64 on the host."""

    K: np.ndarray  # (3, 3) pinhole intrinsics of the rendered images
    R: np.ndarray  # (3, 3) rows: the plate's x and y axes and its normal, in camera coordinates
    t_cam: np.ndarray  # (n, 3) the plate's origin in the camera frame, per frame (m)
    plane_to_image: np.ndarray  # (n, 3, 3) homography: plate plane (m, z = 0) -> pixels
    times_s: np.ndarray  # (n,) capture time of each frame
    speed_kmh: float  # of the car relative to the camera
    corners_px: np.ndarray  # (4, 2) plate corners in frame 0, clockwise from top-right


@dataclass
class Clip:
    grays: np.ndarray  # (n, H, W) uint8
    truth: Truth


def clip_seed(seed: int, index: int) -> int:
    """A generator seed (64 bits) for clip ``index`` of a pool drawn from ``seed``."""
    return (int(seed) * 1_000_003 + index * 7_919 + 0x5EED) % (1 << 63)


def pool(scene: dict, n_frames: int, size: int, device, bank: int = BANK) -> list:
    """The clips of a run: slot j of ``bank`` has paint and noise of its own
    seeds, the same for every run. How long the program works on a clip
    (where its tracks die, what it re-seeds, how long its solvers iterate)
    follows from both, so a pool that moved with the run's seed would move
    the work with it; the run's seed chooses the order of the slots
    (``order``). Other banks are other sets of the same sizes and motion."""
    return [render(scene, n_frames, clip_seed(bank, 2 * j), clip_seed(bank, 2 * j + 1), device)
            for j in range(size)]


def order(seed: int, size: int) -> list:
    """The order in which a run with ``seed`` cycles through its pool."""
    rng = random.Random(int(seed))
    slots = list(range(size))
    rng.shuffle(slots)
    return slots


def _rotation(yaw: float, pitch: float) -> np.ndarray:
    """Row-vector plate rotation: rows are the plate axes in camera coordinates."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return Rx @ Ry


def plate_corners(width_m: float, height_m: float) -> np.ndarray:
    """(4, 3) plate corners on the z = 0 plane, clockwise from top-right."""
    signs = np.array([[1, -1, 0], [1, 1, 0], [-1, 1, 0], [-1, -1, 0]], np.float64)
    return signs * np.array([width_m, height_m, 0.0]) / 2


def truth(scene: dict, n_frames: int) -> Truth:
    """The scene's geometry over ``n_frames`` frames (no rendering)."""
    f = float(scene["focal_px"])
    cx, cy = (float(v) for v in scene["principal_point"])
    K = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])
    R = _rotation(math.radians(scene["yaw_deg"]), math.radians(scene["pitch_deg"]))
    t0 = np.array([*scene["offset_m"], scene["depth0_m"]], np.float64)
    d = np.asarray(scene["direction"], np.float64)
    v = d / np.linalg.norm(d) * (scene["speed_kmh"] / 3.6)
    rate = scene["fps"] / scene["stride"]
    times = np.arange(n_frames) / rate
    t_cam = t0[None, :] + v[None, :] * times[:, None]
    H = np.stack([K @ np.stack([R[0], R[1], t_cam[i]], axis=1) for i in range(n_frames)])
    pc = plate_corners(*scene["plate_m"]) @ R + t_cam[0]
    corners = (pc @ K.T)[:, :2] / pc[:, 2:3]
    speed = float(np.linalg.norm(np.diff(t_cam, axis=0), axis=1).mean() * rate * 3.6)
    return Truth(K=K, R=R, t_cam=t_cam, plane_to_image=H, times_s=times, speed_kmh=speed,
                 corners_px=corners)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with edge-replicated borders, (H, W)."""
    r = max(1, int(round(3 * sigma)))
    x = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    out = img[None, None]
    out = torch.nn.functional.pad(out, (r, r, r, r), mode="replicate")
    out = torch.nn.functional.conv2d(out, k.view(1, 1, 1, -1))
    out = torch.nn.functional.conv2d(out, k.view(1, 1, -1, 1))
    return out[0, 0]


def _texture(scene: dict, gen: torch.Generator, device) -> torch.Tensor:
    """(rows, cols) float32 paint over the car's extent at ``texel_m``: blocks,
    then the dark holder, the light plate and dark characters with holes."""
    x0m, x1m = scene["car_x_m"]
    y0m, y1m = scene["car_y_m"]
    texel = scene["texel_m"]
    W = int(round((x1m - x0m) / texel))
    H = int(round((y1m - y0m) / texel))
    u = torch.rand((PAINT_BLOCKS, 5), generator=gen, device=device, dtype=torch.float64)
    lo, hi = BLOCK_SIZE
    w = (lo + u[:, 0] * (hi - lo)).floor()
    h = (lo + u[:, 1] * (hi - lo)).floor()
    bx = (u[:, 2] * (W - w)).floor()
    by = (u[:, 3] * (H - h)).floor()
    level = PAINT_LEVELS[0] + u[:, 4] * (PAINT_LEVELS[1] - PAINT_LEVELS[0])
    cols = torch.arange(W, device=device, dtype=torch.float64)
    rows = torch.arange(H, device=device, dtype=torch.float64)
    in_x = (cols[None] >= bx[:, None]) & (cols[None] < (bx + w)[:, None])  # (B, W)
    in_y = (rows[None] >= by[:, None]) & (rows[None] < (by + h)[:, None])  # (B, H)
    # the last block painted over a texel is the one that shows
    order = torch.arange(1, PAINT_BLOCKS + 1, device=device)
    top = ((in_y[:, :, None] & in_x[:, None, :]) * order[:, None, None]).amax(0)
    tex = torch.where(top > 0, level[(top - 1).clamp(min=0)],
                      torch.full_like(top, BASE_LEVEL, dtype=torch.float64))

    def px(x, y):  # plate-frame metres -> texel index
        return int(round((x - x0m) / texel)), int(round((y - y0m) / texel))

    pw, ph = scene["plate_m"]
    m = PLATE_MARGIN_M
    a0, b0 = px(-pw / 2 - m, -ph / 2 - m)
    a1, b1 = px(pw / 2 + m, ph / 2 + m)
    tex[b0:b1, a0:a1] = 35.0
    a0, b0 = px(-pw / 2, -ph / 2)
    a1, b1 = px(pw / 2, ph / 2)
    tex[b0:b1, a0:a1] = 235.0
    holes = torch.rand((CHARACTERS, 3), generator=gen, device=device,
                       dtype=torch.float64).cpu().numpy()
    for c in range(CHARACTERS):
        cx0 = -pw / 2 + 0.02 + c * 0.056
        a0, b0 = px(cx0, -0.045)
        a1, b1 = px(cx0 + 0.040, 0.045)
        tex[b0:b1, a0:a1] = 30.0
        ha = a0 + 2 + int(holes[c, 0] * (a1 - 4 - (a0 + 2)))
        hb = b0 + 2 + int(holes[c, 1] * (b1 - 6 - (b0 + 2)))
        tex[hb:hb + 3 + int(holes[c, 2] * 3), ha:ha + 3] = 235.0
    return _blur(tex.float(), TEXTURE_BLUR)


def _background(gen: torch.Generator, height: int, width: int, device) -> torch.Tensor:
    """Smooth, low-contrast static scene: upsampled coarse noise + gradient."""
    coarse = torch.rand((1, 1, 5, 8), generator=gen, device=device) * 2 - 1
    smooth = torch.nn.functional.interpolate(coarse, size=(height, width), mode="bilinear",
                                             align_corners=True)[0, 0]
    grad = torch.linspace(-1.0, 1.0, height, device=device)[:, None]
    return 120.0 + 12.0 * smooth + 8.0 * grad


def _sample(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear texture lookup at fractional texel coordinates (clamped)."""
    H, W = tex.shape
    u = u.clamp(0, W - 1.001)
    v = v.clamp(0, H - 1.001)
    x0 = u.floor().long()
    y0 = v.floor().long()
    fx = u - x0
    fy = v - y0
    flat = tex.reshape(-1)
    i00 = y0 * W + x0
    return ((1 - fy) * ((1 - fx) * flat[i00] + fx * flat[i00 + 1])
            + fy * ((1 - fx) * flat[i00 + W] + fx * flat[i00 + W + 1]))


def render(scene: dict, n_frames: int, paint_seed: int, noise_seed: int, device) -> Clip:
    """Render ``n_frames`` frames of the scene: ``paint_seed`` draws the car's
    paint and the background, ``noise_seed`` the sensor noise. Frames are
    computed a few million pixels at a time on ``device``."""
    tr = truth(scene, n_frames)
    width, height = int(scene["width"]), int(scene["height"])
    gen = torch.Generator(device=device)
    gen.manual_seed(paint_seed)
    tex = _texture(scene, gen, device)
    bg = _background(gen, height, width, device)
    gen.manual_seed(noise_seed)
    x0m, x1m = scene["car_x_m"]
    y0m, y1m = scene["car_y_m"]
    texel = scene["texel_m"]
    f = float(tr.K[0, 0])
    inv = torch.as_tensor(np.linalg.inv(tr.plane_to_image), dtype=torch.float64, device=device)
    xs = torch.arange(width, device=device, dtype=torch.float64)
    out = torch.empty((n_frames, height, width), dtype=torch.uint8, device=device)
    band = max(1, (1 << 22) // width)  # rows a pass
    for i in range(n_frames):
        for r0 in range(0, height, band):
            ys = torch.arange(r0, min(height, r0 + band), device=device, dtype=torch.float64)
            Y, X = torch.meshgrid(ys, xs, indexing="ij")
            Hi = inv[i]
            qw = Hi[2, 0] * X + Hi[2, 1] * Y + Hi[2, 2]
            PX = (Hi[0, 0] * X + Hi[0, 1] * Y + Hi[0, 2]) / qw
            PY = (Hi[1, 0] * X + Hi[1, 1] * Y + Hi[1, 2]) / qw
            car = _sample(tex, ((PX - x0m) / texel).float(), ((PY - y0m) / texel).float())
            # soft silhouette: coverage from the distance to the car's edge in
            # pixels (one pixel spans ~depth/f metres on the plane)
            inside = torch.minimum(torch.minimum(PX - x0m, x1m - PX),
                                   torch.minimum(PY - y0m, y1m - PY))
            alpha = (inside / (tr.t_cam[i, 2] / f) + 0.5).clamp(0.0, 1.0).float()
            img = alpha * car + (1.0 - alpha) * bg[r0:r0 + len(ys)]
            img = img + torch.randn(img.shape, generator=gen, device=device) * scene["noise"]
            out[i, r0:r0 + len(ys)] = img.round().clamp(0, 255).to(torch.uint8)
    return Clip(grays=out.cpu().numpy(), truth=tr)
