"""TextureManager — counterpart of ``vqengine_tpu/scene/texture_manager.py``
(the reference's Source/Renderer/Resources/TextureManager.{h,cpp}): the
async texture loading state machine, path-dedup cache, procedural textures
(checkerboard, Renderer.h:77-84, and the Sponza-substitute maps), mip
generation, the combined auxiliary maps and the (diffuse, aux) pair table.

All textures normalize into one fixed-size array of textures with a full
mip chain ([N, S, S, 4] per mip level). Disk decode runs on a host thread
pool (the reference's mWorkers); `build_device_arrays_packed` packs the
levels as quad-packed RGBA8 (ops.texture.PackedTextures) on a torch device.
"""
from __future__ import annotations

import concurrent.futures as futures
import enum
from pathlib import Path

import numpy as np

from ..utils import native
from ..utils.log import warning


class ETextureState(enum.IntEnum):
    """Reference TextureManager.h:52-61."""
    PENDING = 0
    READING = 1
    MIP_GENERATING = 2
    ALLOCATING = 3
    UPLOADING = 4
    READY = 5
    FAILED = 6


def _resize_box(img: np.ndarray, size: int) -> np.ndarray:
    """Box resample to size x size (any input size; nearest for upsample)."""
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    ys = (np.arange(size) * (h / size)).astype(np.int32)
    xs = (np.arange(size) * (w / size)).astype(np.int32)
    return img[np.clip(ys, 0, h - 1)][:, np.clip(xs, 0, w - 1)]


def _to_rgba_f32(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if c == 1:
        img = np.repeat(img, 3, axis=2)
        c = 3
    if c == 2:
        img = np.concatenate([img[:, :, :1].repeat(3, 2), img[:, :, 1:2]], 2)
        c = 4
    if c == 3:
        img = np.concatenate([img, np.ones_like(img[:, :, :1])], axis=2)
    return img[:, :, :4]


def mip_box(img: np.ndarray) -> np.ndarray:
    """One 2x2 box-filtered level of f32 [H, W, C] or [H, W] -> [max(H // 2,
    1), max(W // 2, 1)(, C)]: each texel 0.25 * (((a + b) + c) + d) over its
    block's (y0, x0), (y0, x1), (y1, x0), (y1, x1), the last row and column
    clamped on a side of 1; the plain version of utils.native.mip_box, the
    order of the JAX package's native mip kernel (vq_mip_box)."""
    h2, w2 = max(img.shape[0] // 2, 1), max(img.shape[1] // 2, 1)
    r0 = img[0:2 * h2:2]
    r1 = img[1:2 * h2:2] if img.shape[0] > 1 else r0
    x0 = slice(0, 2 * w2, 2)
    x1 = slice(1, 2 * w2, 2) if img.shape[1] > 1 else x0
    s = ((r0[:, x0] + r0[:, x1]) + r1[:, x0]) + r1[:, x1]
    return (np.float32(0.25) * s).astype(np.float32)


def generate_mips(img: np.ndarray) -> list[np.ndarray]:
    """Full mip chain by 2x2 box filter (the reference's mip workers), each
    level from the host library's vq_mip_box (utils/native.py)."""
    mips = [img]
    cur = img
    while min(cur.shape[:2]) > 1:
        cur = native.mip_box(cur)
        mips.append(cur)
    return mips


# ---------------------------------------------------------------------------
# procedural textures (reference EProceduralTextures, Renderer.h:77-84)
# ---------------------------------------------------------------------------

def checkerboard(size: int = 256, tiles: int = 8,
                 c0=(1.0, 1.0, 1.0), c1=(0.0, 0.0, 0.0)) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size]
    v = (((y * tiles // size) + (x * tiles // size)) % 2).astype(np.float32)
    img = np.asarray(c0, np.float32)[None, None] * (1 - v[..., None]) \
        + np.asarray(c1, np.float32)[None, None] * v[..., None]
    return _to_rgba_f32(img)


def checkerboard_grayscale(size: int = 256, tiles: int = 8) -> np.ndarray:
    return checkerboard(size, tiles, (0.8, 0.8, 0.8), (0.3, 0.3, 0.3))


def flat_normal(size: int = 4) -> np.ndarray:
    img = np.zeros((size, size, 3), np.float32)
    img[:] = [0.5, 0.5, 1.0]
    return _to_rgba_f32(img)


def brick(size: int = 128, rows: int = 8, mortar: float = 0.06,
          c_brick=(0.58, 0.31, 0.22), c_mortar=(0.72, 0.70, 0.66),
          seed: int = 5) -> np.ndarray:
    """Procedural brick diffuse (the Sponza-substitute wall look)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    ry = y * rows
    row = np.floor(ry)
    fx = (x * rows / 2.0 + (row % 2) * 0.5) % 1.0
    fy = ry % 1.0
    is_mortar = (fy < mortar) | (fy > 1 - mortar) \
        | (fx < mortar / 2) | (fx > 1 - mortar / 2)
    shade = 0.85 + 0.3 * rng.random((int(rows), int(rows // 2) + 2))
    sh = shade[row.astype(int) % rows,
               np.floor(x * rows / 2.0 + (row % 2) * 0.5).astype(int) % (rows // 2 + 2)]
    img = np.where(is_mortar[..., None], np.asarray(c_mortar, np.float32),
                   np.asarray(c_brick, np.float32) * sh[..., None])
    return _to_rgba_f32(img.astype(np.float32))


def noise_texture(size: int = 128, base: float = 0.5, amp: float = 0.35,
                  octaves: int = 4, seed: int = 9) -> np.ndarray:
    """Tileable value-noise grayscale (roughness/height maps)."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((size, size), np.float32)
    for o in range(octaves):
        n = 4 << o
        g = rng.random((n, n)).astype(np.float32)
        g = np.concatenate([g, g[:, :1]], axis=1)
        g = np.concatenate([g, g[:1, :]], axis=0)
        t = np.linspace(0, n, size, endpoint=False)
        i = np.floor(t).astype(int)
        f = (t - i)[None, :]
        fv = (t - i)[:, None]
        a = g[np.ix_(i, i)] * (1 - f) + g[np.ix_(i, i + 1)] * f
        b = g[np.ix_(i + 1, i)] * (1 - f) + g[np.ix_(i + 1, i + 1)] * f
        acc += (a * (1 - fv) + b * fv) * (0.5 ** o)
    acc /= sum(0.5 ** o for o in range(octaves))
    return _to_rgba_f32(np.clip(base + amp * (acc * 2 - 1), 0, 1)[..., None])


def normal_from_height(height_rgba: np.ndarray, strength: float = 2.0) -> np.ndarray:
    """Tangent-space normal map from a height texture (wraps)."""
    h = height_rgba[..., 0]
    dx = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) * strength
    dy = (np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)) * strength
    n = np.stack([-dx, -dy, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return _to_rgba_f32((n * 0.5 + 0.5).astype(np.float32))


class TextureManager:
    def __init__(self, size: int = 256, num_workers: int = 4):
        self.size = size
        self._images: list[np.ndarray] = []   # [S, S, 4] f32 each
        self._by_key: dict[str, int] = {}
        self._states: dict[int, ETextureState] = {}
        self._pool = futures.ThreadPoolExecutor(max_workers=num_workers)
        self._pending: dict[int, futures.Future] = {}
        self._pairs: list[tuple] = []   # (diffuse_id, aux_id) pair table

    # ------------------------------------------------------------------
    def create_from_array(self, key: str, img: np.ndarray) -> int:
        if key in self._by_key:
            return self._by_key[key]
        tid = len(self._images)
        self._images.append(_resize_box(_to_rgba_f32(img), self.size))
        self._by_key[key] = tid
        self._states[tid] = ETextureState.READY
        return tid

    def create_from_file(self, path: str | Path, search_dirs=()) -> int:
        """Queue an async disk load (dedup by path). Returns the id
        immediately; the slot holds a placeholder until wait_all()."""
        key = str(path)
        if key in self._by_key:
            return self._by_key[key]
        # the decoder's library builds here, in the caller, so that a
        # failed build raises instead of failing each texture in a worker
        native.library()
        tid = len(self._images)
        self._images.append(np.zeros((self.size, self.size, 4), np.float32))
        self._by_key[key] = tid
        self._states[tid] = ETextureState.READING

        def load():
            from ..utils.image_io import read_hdr, read_png
            for base in list(search_dirs) + ["."]:
                p = Path(base) / path
                if not p.is_file():
                    continue
                try:
                    if p.suffix.lower() == ".hdr":
                        img = read_hdr(p)
                    else:
                        img = read_png(p)
                    self._states[tid] = ETextureState.MIP_GENERATING
                    self._images[tid] = _resize_box(_to_rgba_f32(img), self.size)
                    self._states[tid] = ETextureState.READY
                    return
                except Exception as e:  # noqa: BLE001
                    warning(f"texture decode failed {p}: {e}")
            self._states[tid] = ETextureState.FAILED

        self._pending[tid] = self._pool.submit(load)
        return tid

    def combine_aux_maps(self, materials) -> int:
        """Bake each material's normal/roughness/metallic maps into ONE
        RGBA map (R,G = tangent normal xy; B = roughness; A = metalness)
        and point the material's `combined_aux` at it, clearing the
        separate slots. Texture sampling on TPU is fetch-count-bound
        (~6 ms per sampled map per 1080p frame), so fusing three maps
        into one fetch is a pure win; z reconstructs as sqrt(1-x^2-y^2)
        at shading time. Materials with fewer than two of those maps are
        left alone (no gain). Returns the number of materials combined.

        Counterpart of the reference's OcclRoughMtlMap channel packing
        (LightingConstantBufferData.h ORM slot) taken one step further.
        """
        self.wait_all()
        cache: dict[tuple, int] = {}
        combined = 0
        for mat in materials:
            n_id = mat.textures.get("normal", -1)
            r_id = mat.textures.get("roughness", -1)
            m_id = mat.textures.get("metallic", -1)
            if (n_id >= 0) + (r_id >= 0) + (m_id >= 0) < 2:
                continue
            key = (n_id, r_id, m_id)
            tid = cache.get(key)
            if tid is None:
                s = self.size
                img = np.empty((s, s, 4), np.float32)
                img[..., 0:2] = (self._images[n_id][..., 0:2]
                                 if n_id >= 0 else 0.5)
                img[..., 2] = (self._images[r_id][..., 0]
                               if r_id >= 0 else 1.0)
                img[..., 3] = (self._images[m_id][..., 0]
                               if m_id >= 0 else 1.0)
                tid = self.create_from_array(f"aux:{n_id}:{r_id}:{m_id}", img)
                cache[key] = tid
            mat.combined_aux = tid
            for slot in ("normal", "roughness", "metallic"):
                mat.textures.pop(slot, None)
            combined += 1
        return combined

    def combine_pair_quads(self, materials) -> int:
        """Register a (diffuse, combined_aux) PAIR texture for each
        material that samples either, so the material pass fetches both
        quads in ONE 32 B gather row (texture cost is fetch-count-bound;
        see ops/texture.PackedTextures.pair_flat). Call AFTER
        combine_aux_maps. Returns the number of materials paired.

        All-or-nothing per scene: a material with a nonzero
        normal_map_mip_bias needs the aux tap at a different mip than
        the diffuse tap, which the shared pair row can't express — if
        any textured material has one, nothing is paired (the classic
        2-fetch path still renders it correctly)."""
        mats = list(materials)
        for mat in mats:
            if (mat.textures.get("diffuse", -1) >= 0
                    or mat.combined_aux >= 0) \
                    and mat.normal_map_mip_bias != 0.0:
                return 0
        cache: dict[tuple, int] = {}
        paired = 0
        for mat in mats:
            d_id = mat.textures.get("diffuse", -1)
            a_id = mat.combined_aux
            if d_id < 0 and a_id < 0:
                continue
            key = (d_id, a_id)
            pid = cache.get(key)
            if pid is None:
                pid = len(self._pairs)
                self._pairs.append(key)
                cache[key] = pid
            mat.pair_map = pid
            paired += 1
        return paired

    def wait_all(self) -> None:
        """Join outstanding loads (the WaitForTexture latch)."""
        for f in self._pending.values():
            f.result()
        self._pending.clear()

    def state(self, tid: int) -> ETextureState:
        return self._states.get(tid, ETextureState.FAILED)

    @property
    def count(self) -> int:
        return len(self._images)

    # ------------------------------------------------------------------
    def _levels(self) -> list[np.ndarray]:
        """-> per mip level [N, s, s, 4] f32 of every texture."""
        self.wait_all()
        if not self._images:
            self._images.append(np.ones((self.size, self.size, 4), np.float32))
        per_tex_mips = [generate_mips(img) for img in self._images]
        return [np.stack([m[lvl] for m in per_tex_mips])
                for lvl in range(len(per_tex_mips[0]))]

    def build_device_arrays(self, device) -> list:
        """-> list per mip level of [N, s, s, 4] f32 tensors on `device`
        (the upload; the exact/HDR layout)."""
        import torch
        return [torch.from_numpy(lvl).to(device) for lvl in self._levels()]

    def build_device_arrays_packed(self, device):
        """-> ops.texture.PackedTextures (quad-packed RGBA8, with the pair
        rows when pairs are registered) on `device`: one row gather per
        bilinear tap at shading time, the production layout."""
        from ..ops.texture import pack_texture_pairs, pack_texture_quads
        levels = self._levels()
        packed = pack_texture_quads(levels, device)
        if self._pairs:
            packed = pack_texture_pairs(levels, self._pairs, packed)
        return packed
