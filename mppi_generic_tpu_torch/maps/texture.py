"""Map textures, in PyTorch: a device-resident array and an exact-f32
bilinear (2D) or trilinear (3D, ``MapTexture3D``) lookup.

Counterpart of ``MapTexture2D``, ``MapTexture3D`` and ``load_track_npz`` in
``mppi_generic_tpu/maps/texture.py`` (the reference's texture helpers,
texture_helper.cu:94-134). The coordinate pipeline is the JAX package's:

* world -> map: map = R (world - origin), R rows as the reference stores
  them;
* map -> normalized tex coords: u = (map_x / resolution_x) / W, and the
  same for v with H;
* query: CUDA ``cudaFilterModeLinear`` with ``cudaAddressModeClamp`` on
  normalized coordinates: the sample position x = u W - 0.5 is clamped to
  [0, W - 1], and the value is the lerp between the two clamped neighbour
  texels of each axis (``_bilinear_axis``).

The lerp is the four-tap formula ``top = v00 + fx (v01 - v00)``, ``bot =
v10 + fx (v11 - v10)``, ``top + fy (bot - top)``: the eager query here and
the kernels' device function (``csrc/map_texture.cuh``) compute it with the
same operations, so the combined path and the kernels agree on the map
term to the last bit. The JAX package's tent-mask MXU product, HBM window
and bf16x3 are TPU mechanics and are not ported; its one-hot matmul (maps
up to 512 per side) sums the same four terms in another order.

A NaN sample position gives NaN, as in the JAX package.

Besides the component forms the kernels mirror, the pose forms of the JAX
package take a trailing (..., 3) world or map pose: ``world_to_map``,
``map_to_tex``, ``world_to_tex``, ``query_at_map_pose``,
``query_at_world_pose`` and ``query_at_world_offset_pose``.

Data layouts: (H, W); (H, W, CH) with a trailing channel axis; or
(CH, H, W) with ``channel_major=True`` (the reference's float4 planes).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mppi_generic_tpu_torch.utils import math_utils


class MapTexture2D(nn.Module):
    def __init__(self, data, origin=(0.0, 0.0, 0.0), rotation=None, resolution=1.0,
                 channel_major=False, device="cpu"):
        super().__init__()
        data = np.asarray(data, np.float32)
        if channel_major and data.ndim != 3:
            raise ValueError("channel_major requires (CH, H, W) data")
        if data.ndim not in (2, 3):
            raise ValueError(f"a 2D map is (H, W) or three-dimensional, got {data.shape}")
        self.channel_major = bool(channel_major)
        rotation = np.eye(3, dtype=np.float32) if rotation is None else rotation
        resolution = np.asarray(resolution, np.float32)
        if resolution.ndim == 0:
            resolution = np.full((3,), resolution, np.float32)

        def f32(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)

        self.register_buffer("data", f32(data))
        self.register_buffer("origin", f32(origin).reshape(3))
        self.register_buffer("rotation", f32(rotation).reshape(3, 3))
        self.register_buffer("resolution", f32(resolution).reshape(3))
        # the extent as device scalars: u = map_x / res / W divides by them
        # (on CUDA, a division by a host number is a multiply by its
        # reciprocal)
        self.register_buffer("extent", f32([self.width, self.height]))

    @property
    def height(self) -> int:
        return int(self.data.shape[1 if self.channel_major else 0])

    @property
    def width(self) -> int:
        return int(self.data.shape[2 if self.channel_major else 1])

    @property
    def channels(self) -> int:
        """0 for single-channel (H, W) data."""
        if self.data.dim() == 2:
            return 0
        return int(self.data.shape[0 if self.channel_major else 2])

    # --- coordinate pipeline (texture_helper.cu:94-134) ---------------------
    def world_to_map(self, world):
        """world (..., 3) -> map-frame meters (..., 3): R (world - origin)."""
        return torch.einsum("ij,...j->...i", self.rotation, world - self.origin)

    def map_to_tex(self, map_pose):
        """map meters (..., >= 2) -> normalized tex coords (u, v)."""
        u = map_pose[..., 0] / self.resolution[0] / self.extent[0]
        v = map_pose[..., 1] / self.resolution[1] / self.extent[1]
        return u, v

    def world_to_tex(self, world):
        return self.map_to_tex(self.world_to_map(world))

    def world_to_tex_components(self, wx, wy, wz=0.0):
        """(wx, wy[, wz]) world components -> normalized (u, v)."""
        R = self.rotation
        dx = wx - self.origin[0]
        dy = wy - self.origin[1]
        dz = wz - self.origin[2]
        mx = R[0, 0] * dx + R[0, 1] * dy + R[0, 2] * dz
        my = R[1, 0] * dx + R[1, 1] * dy + R[1, 2] * dz
        u = mx / self.resolution[0] / self.extent[0]
        v = my / self.resolution[1] / self.extent[1]
        return u, v

    def query_world_components(self, wx, wy, wz=0.0):
        """Bilinear lookup at world (wx, wy[, wz]) given component-wise."""
        u, v = self.world_to_tex_components(wx, wy, wz)
        return self.query_tex(u, v)

    def query_world_components_channel(self, wx, wy, ch: int, wz=0.0):
        """``query_world_components`` of one channel."""
        u, v = self.world_to_tex_components(wx, wy, wz)
        return self.query_tex_channel(u, v, ch)

    # --- queries ----------------------------------------------------------
    def plane(self, ch: int = 0):
        """(offset, stride) of channel ``ch`` in the flattened data: texel
        (y, x) of the channel sits at offset + (y W + x) stride."""
        n = self.channels
        if not 0 <= ch < max(n, 1):
            raise ValueError(f"channel {ch} of a map with {max(n, 1)} channel(s)")
        if n == 0:
            return 0, 1
        if self.channel_major:
            return ch * self.height * self.width, 1
        return ch, n

    def query_tex(self, u, v):
        """Bilinear lookup at normalized (u, v); u indexes the width (x), v
        the height (y). Multichannel maps return a trailing channel axis."""
        if self.channels == 0:
            return self.query_tex_channel(u, v, 0)
        return torch.stack([self.query_tex_channel(u, v, c)
                            for c in range(self.channels)], dim=-1)

    def query_tex_channel(self, u, v, ch: int):
        """Bilinear lookup of one channel (single-channel maps take ch=0)."""
        offset, stride = self.plane(ch)
        H, W = self.height, self.width
        x0, x1, fx = _bilinear_axis(u, W)
        y0, y1, fy = _bilinear_axis(v, H)
        flat = self.data.reshape(-1)

        def tap(yi, xi):
            return flat[offset + (yi * W + xi) * stride]

        v00, v01, v10, v11 = tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1)
        top = v00 + fx * (v01 - v00)
        bot = v10 + fx * (v11 - v10)
        return top + fy * (bot - top)

    def query_at_map_pose(self, map_pose):
        return self.query_tex(*self.map_to_tex(map_pose))

    def query_at_world_pose(self, world):
        return self.query_tex(*self.world_to_tex(world))

    def query_at_world_offset_pose(self, world, offset, rotation_rpy):
        """queryTextureAtWorldOffsetPose (texture_helper.cu:137-144): the
        body-frame ``offset`` (..., 3) rotated into the world by the Z-Y-X
        Euler angles ``rotation_rpy`` (3, ...), added to ``world``, then
        queried."""
        q = math_utils.euler_to_quat(rotation_rpy[0], rotation_rpy[1], rotation_rpy[2])
        return self.query_at_world_pose(world + math_utils.quat_rotate(q, offset))

    def kernel_meta(self, ch: int = 0):
        """The kernels' description of channel ``ch`` (csrc/map_texture.cuh
        ``MapTex``): the int32 words [H, W, offset, stride] and the float32
        origin (3), rotation rows (9) and resolution (3)."""
        offset, stride = self.plane(ch)
        return ([self.height, self.width, offset, stride],
                torch.cat([self.origin, self.rotation.reshape(-1), self.resolution]))


class MapTexture3D(nn.Module):
    """A layered (D, H, W) map with a trilinear lookup (the reference's
    ThreeDTextureHelper; ``MapTexture3D`` in the JAX package's
    maps/texture.py:647-743). The world -> map -> tex pipeline of
    ``MapTexture2D`` with a third axis, then CUDA's linear filter with clamp
    addressing on each axis: the bilinear plane at the two depth layers
    around the sample, lerped by the depth fraction. The JAX package sums
    the two planes by a one-hot weighted reduction where the map fits its
    MXU (up to 256 texels a side and 32 layers) and by this lerp otherwise;
    the values agree to the last bits."""

    def __init__(self, data, origin=(0.0, 0.0, 0.0), rotation=None, resolution=1.0,
                 device="cpu"):
        super().__init__()
        data = np.asarray(data, np.float32)
        if data.ndim != 3:
            raise ValueError(f"a 3D map is (D, H, W), got {data.shape}")
        rotation = np.eye(3, dtype=np.float32) if rotation is None else rotation
        resolution = np.asarray(resolution, np.float32)
        if resolution.ndim == 0:
            resolution = np.full((3,), resolution, np.float32)

        def f32(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)

        self.register_buffer("data", f32(data))
        self.register_buffer("origin", f32(origin).reshape(3))
        self.register_buffer("rotation", f32(rotation).reshape(3, 3))
        self.register_buffer("resolution", f32(resolution).reshape(3))
        self.register_buffer("extent", f32([self.width, self.height, self.depth]))

    @property
    def depth(self) -> int:
        return int(self.data.shape[0])

    @property
    def height(self) -> int:
        return int(self.data.shape[1])

    @property
    def width(self) -> int:
        return int(self.data.shape[2])

    def world_to_map(self, world):
        """world (..., 3) -> map-frame meters (..., 3): R (world - origin)."""
        return torch.einsum("ij,...j->...i", self.rotation, world - self.origin)

    def map_to_tex(self, map_pose):
        """map meters (..., 3) -> normalized tex coords (u, v, w)."""
        return tuple(map_pose[..., i] / self.resolution[i] / self.extent[i]
                     for i in range(3))

    def query_tex(self, u, v, w):
        """Trilinear lookup at normalized (u, v, w): u indexes the width, v
        the height, w the depth."""
        x0, x1, fx = _bilinear_axis(u, self.width)
        y0, y1, fy = _bilinear_axis(v, self.height)
        z0, z1, fz = _bilinear_axis(w, self.depth)
        d = self.data

        def plane(z):
            v00, v01 = d[z, y0, x0], d[z, y0, x1]
            v10, v11 = d[z, y1, x0], d[z, y1, x1]
            top = v00 + fx * (v01 - v00)
            bot = v10 + fx * (v11 - v10)
            return top + fy * (bot - top)

        p0, p1 = plane(z0), plane(z1)
        return p0 + fz * (p1 - p0)

    def query_at_map_pose(self, map_pose):
        return self.query_tex(*self.map_to_tex(map_pose))

    def query_at_world_pose(self, world):
        return self.query_at_map_pose(self.world_to_map(world))


def _bilinear_axis(coord, n: int):
    """CUDA linear-filter sample setup along one axis with clamp addressing:
    normalized coordinate -> (lo index, hi index, fraction). A NaN
    coordinate reads texel 0 with a NaN fraction, so the value is NaN."""
    x = (coord * n - 0.5).clamp(0.0, n - 1.0)
    lo = torch.floor(x)
    frac = x - lo
    lo_i = torch.nan_to_num(lo, nan=0.0).to(torch.int64)
    return lo_i, (lo_i + 1).clamp_max(n - 1), frac


def load_track_npz(path_or_dict, device="cpu") -> MapTexture2D:
    """Load the reference's AutoRally track-map npz into a channel-major
    :class:`MapTexture2D` (``loadTrackData``, ar_standard_cost.cu:85-140):
    ``xBounds`` (2,), ``yBounds`` (2,), ``pixelsPerMeter`` (1,) and
    ``channel0..3``, row-major float planes of (H, W) = ((y_max - y_min) ppm,
    (x_max - x_min) ppm). origin = (x_min, y_min), resolution = 1 / ppm, so
    u = (x - x_min) / (x_max - x_min) as the reference's transform. Accepts
    a path or an already loaded mapping."""
    d = path_or_dict
    if not hasattr(d, "__getitem__") or isinstance(d, (str, bytes)):
        d = np.load(d)
    x_min, x_max = (float(v) for v in np.asarray(d["xBounds"]).reshape(-1))
    y_min, y_max = (float(v) for v in np.asarray(d["yBounds"]).reshape(-1))
    ppm = float(np.asarray(d["pixelsPerMeter"]).reshape(-1)[0])
    W = int((x_max - x_min) * ppm)
    H = int((y_max - y_min) * ppm)
    chans = [np.asarray(d[f"channel{i}"], np.float32).reshape(H, W) for i in range(4)]
    return MapTexture2D(np.stack(chans), origin=(x_min, y_min, 0.0),
                        resolution=1.0 / ppm, channel_major=True, device=device)
