"""Count where the port's mirrors of the reference's CPU roundings differ
from the reference (the JAX package, run op by op on the CPU):

    JAX_PLATFORMS=cpu python tools/rounding_probes_torch.py [--ibl]

Prints one line per probe: XLA's exp (ops/texture.exp_xla), log10
(ops/culling.log10_xla), glibc's powf (ops/colorspace.powf, the sRGB
decode), the sum orders of the tessellation einsums, the Rec. 709/2020
matrices' `c @ M.T` (colorspace.color_matrix) over N rows, against pairs
and an FMA chain in every channel, the PQ curve's base
(c1 + c2 cp) / (1 + c3 cp) and the whole curve, and with --ibl the bf16
environment tables at Sponza's 512x256 sky and the default sizes
(about two minutes on one core). Needs jax, so it runs on a CPU host, not
on the card.
"""
from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import torch

import vqengine_tpu.ops._backend  # noqa: F401  (the reference's matmul precision)
from vqengine_tpu.ops import colorspace as jcs
from vqengine_tpu.ops import tessellation as jt
from vqengine_tpu.render import graph as jg
from vqengine_tpu_torch.ops import colorspace as tcs
from vqengine_tpu_torch.ops import culling as tcull
from vqengine_tpu_torch.ops import ibl as ti
from vqengine_tpu_torch.ops import tessellation as tt
from vqengine_tpu_torch.ops.texture import exp_xla
from vqengine_tpu_torch.render import graph as tg


def differ(a, b) -> int:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return int((a.view(np.uint32) != b.view(np.uint32)).sum())


def main() -> None:
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-100, 100, 1_000_000), rng.uniform(-20, 0, 1_000_000),
                        rng.uniform(-88.0, -87.0, 500_000)]).astype(np.float32)
    ref = jnp.exp(jnp.asarray(x))
    print(f"exp: exp_xla {differ(exp_xla(torch.from_numpy(x)), ref)}, torch.exp "
          f"{differ(torch.exp(torch.from_numpy(x)), ref)} of {x.size} differ")
    a = np.maximum(rng.random(2_000_000) * 10.0 ** rng.uniform(-30, 1, 2_000_000),
                   1e-30).astype(np.float32)
    ref = jnp.log10(jnp.asarray(a))
    print(f"log10: log10_xla {differ(tcull.log10_xla(torch.from_numpy(a)), ref)}, "
          f"torch.log10 {differ(torch.log10(torch.from_numpy(a)), ref)} of {a.size} differ")
    c = np.concatenate([rng.random(200_000), np.arange(256) / 255.0]).astype(np.float32)
    w = (10.0 ** rng.uniform(-45, 1, 500_000)).astype(np.float32)
    ref_c = jcs.srgb_to_linear_fast(jnp.asarray(c))
    f64 = torch.pow(torch.from_numpy(c).double(), float(np.float32(2.2))).float()
    print(f"powf (sRGB decode): powf {differ(tcs.srgb_to_linear_fast(torch.from_numpy(c)), ref_c)} "
          f"of {c.size} in [0, 1] and the RGBA8 levels (f64 pow rounded to f32: "
          f"{differ(f64, ref_c)}), {differ(tcs.powf(torch.from_numpy(w), float(np.float32(2.2))), jnp.power(jnp.asarray(w), np.float32(2.2)))} "
          f"of {w.size} over [1e-45, 10] differ")
    corners = rng.normal(size=(576, 4, 3)).astype(np.float32) * 40
    cam = (rng.normal(size=3) * 60).astype(np.float32)
    fj = jt.edge_factors(jnp.asarray(corners), jnp.asarray(cam), 250.0)
    ft = tt.edge_factors(torch.from_numpy(corners), torch.from_numpy(cam), 250.0)
    print(f"edge factors: {sum(differ(p, q) for p, q in zip(ft, fj))} of "
          f"{5 * corners.shape[0]} differ")
    planes = rng.normal(size=(6, 4)).astype(np.float32)
    print(f"cull (kj,pcj->pkc in pairs): {differ(tt.cull_patches(torch.from_numpy(corners), torch.from_numpy(planes), 1.3).int(), jt.cull_patches(jnp.asarray(corners), jnp.asarray(planes), 1.3).astype(jnp.int32))} "
          f"of {corners.shape[0]} differ")
    b = rng.random((12, 36, 3)).astype(np.float32)
    print(f"eval_tri_patches (pvk,pkc->pvc an FMA chain): "
          f"{differ(tt.eval_tri_patches(torch.from_numpy(corners[:12, :3]), torch.from_numpy(b)), jt.eval_tri_patches(jnp.asarray(corners[:12, :3]), jnp.asarray(b)))} "
          f"of {12 * 36 * 3} differ (12 patches; a single patch is a plain "
          f"dot that XLA sums otherwise)")
    from vqengine_tpu_torch.ops.raster import _fma
    for n in (15, 31, 1000, 1001, 1296, 20736):
        cm = (rng.uniform(-2.0, 20.0, (n, 3))).astype(np.float32)
        ref = jcs.rec709_to_rec2020(jnp.asarray(cm))
        ct = torch.from_numpy(cm)
        mt = torch.tensor(tcs._REC709_TO_REC2020)
        p = [ct[:, None, k] * mt[:, k] for k in range(3)]
        pairs = (p[0] + p[1]) + p[2]
        chain = _fma(ct[:, None, 2], mt[:, 2], _fma(ct[:, None, 1], mt[:, 1], p[0]))
        print(f"Rec709->Rec2020 c @ M.T, N = {n} rows: color_matrix "
              f"{differ(tcs.rec709_to_rec2020(ct), ref)}, pairs in every channel "
              f"{differ(pairs, ref)}, an FMA chain in every channel "
              f"{differ(chain, ref)} of {3 * n} differ")
    pq = np.concatenate([rng.random(300_000) ** 4, rng.uniform(0, 10, 100_000)]
                        ).astype(np.float32)
    cp = tcs.powf(torch.from_numpy(pq), tcs._PQ_M1)
    jcp = jnp.power(jnp.abs(jnp.asarray(pq)), 2610.0 / 4096.0 / 4)
    base = (tcs._PQ_C1 + tcs._PQ_C2 * cp) / (1.0 + tcs._PQ_C3 * cp)
    jbase = (3424.0 / 4096.0 + 2413.0 / 4096.0 * 32 * jcp) / (1.0 + 2392.0 / 4096.0 * 32 * jcp)
    print(f"PQ curve on {pq.size} values in [0, 10]: |c|^m1 {differ(cp, jcp)}, "
          f"the base {differ(base, jbase)}, the curve "
          f"{differ(tcs.linear_to_st2084(torch.from_numpy(pq)), jcs.linear_to_st2084(jnp.asarray(pq)))} "
          f"differ (torch.pow in f64 rounded to f32: "
          f"{differ(torch.pow(base.double(), tcs._PQ_M2).float(), jcs.linear_to_st2084(jnp.asarray(pq)))})")
    if "--ibl" in sys.argv[1:]:
        eq = ti.procedural_sky_equirect(512, 256)
        ref_env = jg.build_environment(jnp.asarray(eq))
        env = tg.build_environment(eq, torch.device("cpu"))

        def b16(t):
            return t.view(torch.int16).numpy()
        rows = [("diffuse cube", env.diffuse_cube, ref_env.diffuse_cube)] + [
            (f"specular mip {m}", p, q)
            for m, (p, q) in enumerate(zip(env.specular_mips, ref_env.specular_mips))]
        print("IBL tables at a 512x256 sky, default sizes: " + ", ".join(
            f"{n} {int((b16(p) != np.asarray(q).view(np.int16)).sum())} of {p.numel()}"
            for n, p, q in rows) + " bf16 entries differ")


if __name__ == "__main__":
    main()
