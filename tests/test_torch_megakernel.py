"""The port's ``render_tiles`` (its plain version, on the CPU) against the JAX
package's ``render_tiles`` in all four sphere-walk modes, (primary,
intersect) in ("off", "split") x ("grouped", "candidates"), with
``exact_rng=True``, the JAX kernel run in Pallas interpret mode as
tests/test_pallas.py runs it. The split takes the same shortlists in both.

Bars (tests/test_pallas.py:24-28, bf16 hi/lo attributes against float32):
r/g/b atol 5e-5, depth atol 1e-3, segment counts equal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu import RaytracedCamera as JRaytracedCamera
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.kernels.cuda import build
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.kernels.cuda import primary

torch.set_num_threads(2)

SLICE = dict(samples_per_pixel=2, bounces=4, level=3, pallas_primary="off",
             pallas_intersect="grouped")


def _inputs(jworld, w, h, cand_size=0):
    js = jworld.extract(with_bvh=False)
    jcam = jworld.camera_state(aspect=w / h)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    return js, jcam, mk.prepare_kernel_scene(ps, cand_size), pcam


def _shortlists(kscene, cam, config, overflow=()):
    """The split's inputs for both packages, from the port's builder on the
    port's sphere table (both pinned equal to the JAX package's); the blocks
    in ``overflow`` are flagged full, so they take the full walk."""
    sl, meta = primary.build_block_shortlists(kscene.sph.numpy(), cam, config)
    meta[list(overflow), 0] = 1.0
    return sl, meta


def _check_against_jax(jworld, w, h, seed, split=False, overflow=(),
                       cand_size=0, mode=None, spp_map=None, sample_offset=0,
                       **options):
    """``spp_map`` (block-ordered int32 numpy targets) and ``sample_offset``
    go to both packages; with a map both return sample sums."""
    js, jcam, kscene, pcam = _inputs(jworld, w, h, cand_size)
    accumulate = dict(sample_offset=sample_offset,
                      normalize=spp_map is None)
    cfg = {**SLICE, **options}
    config = bt.RenderConfig(width=w, height=h, **cfg)
    sl = meta = None
    if split:
        sl, meta = _shortlists(kscene, pcam, config, overflow)
    want = jmk.render_tiles(jmk.jitted_prepare(cand_size, "kd")(js), jcam,
                            JRenderConfig(width=w, height=h, **cfg),
                            np.uint32(seed), exact_rng=True, sl=sl,
                            slmeta=meta, spp_map=spp_map, **accumulate)
    if spp_map is not None:
        accumulate["spp_map"] = torch.as_tensor(spp_map)
    got = mk.render_tiles(kscene, pcam, config, seed,
                          sl=None if sl is None else torch.as_tensor(sl),
                          slmeta=None if meta is None else torch.as_tensor(meta),
                          **accumulate)
    if mode is not None:
        # Every mode walks the same spheres to the same winner, so the port's
        # plain version gives the same bits as in its off/grouped mode.
        assert mk.kernel_mode(kscene, config, sl) == mode
        base = mk.render_tiles(kscene, pcam, dataclasses.replace(
            config, pallas_primary="off", pallas_intersect="grouped"), seed,
            **accumulate)
        for g, b in zip(got, base):
            assert torch.equal(g, b)
    for g, wnt in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=5e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-3)
    assert got[4].dtype == torch.int64
    assert int(got[4]) == int(want[4]) > 0
    return got


@pytest.mark.parametrize("scene_fn,size,seed", [
    (lambda: jrtiow.final_scene(seed=42, grid=4), (64, 64), 11),
    (jrtiow.material_test_scene, (40, 24), 5),   # a ragged block
])
def test_render_tiles_matches_jax(scene_fn, size, seed):
    _check_against_jax(scene_fn(), *size, seed)


LENS = dict(aperture=0.2, focus_distance=4.0)


@pytest.mark.parametrize("scene_fn,options", [
    # The emissive lamps, and level 1's far + 10 fallback depth.
    (jrtiow.night_scene, dict(level=1)),
    # The thin-lens raygen and cosine-weighted diffuse bounces.
    (lambda: jrtiow.material_test_scene(JRaytracedCamera(**LENS)),
     dict(defocus=True, diffuse_sampling="cosine")),
], ids=["night_level1", "defocus_cosine"])
def test_render_tiles_branches_match_jax(scene_fn, options):
    got = _check_against_jax(scene_fn(), 48, 32, 3, **options)
    if options.get("level") == 1:
        # Sky pixels (every sample's first segment missed) carry far + 10.
        assert float(got[3].max()) == pytest.approx(1010.0)


def _grid4():
    return jrtiow.final_scene(seed=42, grid=4)


def _with_duplicates(world, pkg):
    """``world`` with two of its spheres spawned again in another material:
    both copies give the same q, and only the lower index may win."""
    for pos in ((0.0, 1.0, 0.0), (4.0, 1.0, 0.0)):
        world.spawn_sphere(pkg.Transform.from_xyz(*pos),
                           pkg.RaytracedSphere(radius=1.0),
                           pkg.StandardMaterial(base_color=(1.0, 0.0, 0.0)))
    return world


def _grid4_duplicates():
    from bevyray_tpu.scene import components as jcomp
    return _with_duplicates(_grid4(), jcomp)


SPLIT = dict(split=True, pallas_primary="split")


@pytest.mark.parametrize("scene_fn,size,options,mode", [
    (_grid4, (96, 64), dict(SPLIT, pallas_intersect="grouped"),
     ("split", "grouped")),
    (_grid4, (96, 64), dict(SPLIT, pallas_intersect="candidates"),
     ("split", "candidates")),
    (_grid4, (64, 64), dict(pallas_intersect="candidates"),
     ("off", "candidates")),
    # Block 0's shortlist flagged full: its bounce 0 takes the full walk.
    (_grid4, (96, 64), dict(SPLIT, overflow=(0,),
                            pallas_intersect="candidates"),
     ("split", "candidates")),
    (_grid4, (96, 64), dict(SPLIT, overflow=(1,), pallas_intersect="grouped",
                            defocus=True), ("split", "grouped")),
    # 512 padded spheres in groups of 8: 64 candidate groups, three of the
    # JAX kernel's 31-bit mask words; "auto" picks the candidate walk.
    (lambda: jrtiow.final_scene(seed=42), (32, 32),
     dict(SPLIT, cand_size=8, pallas_intersect="auto", samples_per_pixel=1,
          bounces=2), ("split", "candidates")),
    # Duplicate geometry: the shortlist's explicit index tie arm.
    (_grid4_duplicates, (64, 64), dict(SPLIT, pallas_intersect="grouped"),
     ("split", "grouped")),
    # Groups of 24 spheres: the last candidate group is partly empty.
    (_grid4, (64, 64), dict(cand_size=24, pallas_intersect="candidates"),
     ("off", "candidates")),
], ids=["split_grouped", "split_candidates", "off_candidates",
        "overflow_candidates", "overflow_grouped_defocus", "multiword_auto",
        "duplicates_split", "tail_group_gc24"])
def test_render_tiles_modes_match_jax(scene_fn, size, options, mode):
    _check_against_jax(scene_fn(), *size, 11, mode=mode, **options)


@pytest.mark.parametrize("s", [128, 512, 1024, 1152])
def test_mode_resolution_matches_jax(s):
    """``"auto"`` picks the same full walk as the JAX kernel: the candidate
    walk from 512 padded spheres with the split, above 1024 without."""
    scene = mk.KernelScene(sph=torch.zeros(4, s), attr=torch.zeros(13, s),
                           gaabb=torch.zeros(6, 1), tri=torch.zeros(10, 0),
                           gc=16, n_cand=s // 16, cand_off=0)
    for intersect in ("auto", "grouped", "candidates"):
        cfg = bt.RenderConfig(width=8, height=8, pallas_intersect=intersect)
        jcfg = JRenderConfig(width=8, height=8, pallas_intersect=intersect)
        for split in (False, True):
            want = jmk._use_candidate_walk(jcfg, s, phase_split=split)
            assert mk.use_candidate_walk(cfg, s, split) == want
            assert mk.kernel_mode(scene, cfg, 1 if split else None) == (
                "split" if split else "off",
                "candidates" if want else "grouped")


def test_candidate_walk_matches_jax_on_face_plane_rays():
    """The candidate walk alone, JAX's ``_intersect_candidates`` against the
    plain version's, on 4096 rays: random ones, and rays with a direction
    component exactly 0 whose origin lies on a face plane of a candidate
    box. There the slab is 0 * inf = NaN; both packages' min/max keep it,
    so that group is not entered."""
    jw = jrtiow.final_scene(seed=42, grid=4)
    js, _, kscene, _ = _inputs(jw, 64, 64, cand_size=16)
    jscene = jmk.jitted_prepare(16, "kd")(js)
    rng = np.random.default_rng(5)
    n = 4096
    o = rng.uniform(-4.0, 4.0, (3, n)).astype(np.float32)
    o[1] = np.abs(o[1]) + 0.2
    d = rng.normal(size=(3, n)).astype(np.float32)
    box = kscene.gaabb[:, kscene.cand_off:kscene.cand_off + kscene.n_cand]
    box = box.numpy()
    face = np.arange(0, n, 4)            # every 4th ray: on a face plane
    g = face % kscene.n_cand
    axis = (face // 4) % 3
    side = (face // 12) % 2              # min face or max face
    o[axis, face] = box[axis + 3 * side, g]
    d[axis, face] = 0.0
    got_t, got_i = mk._intersect_full(
        bt.Vec3(*map(torch.as_tensor, o)), bt.Vec3(*map(torch.as_tensor, d)),
        kscene, True, {"sphere_tests": 0, "slab_tests": 0})
    entered, _ = mk._candidate_groups(
        bt.Vec3(*map(torch.as_tensor, o)), bt.Vec3(*map(torch.as_tensor, d)),
        torch.as_tensor((d * d).sum(0)), kscene)
    assert not bool(entered[torch.as_tensor(face), torch.as_tensor(g)].any())

    def jax_walk(o, d):
        from bevyray_tpu.core.vec import Vec3 as JVec3
        shape = (32, 128)
        ov = JVec3(*(x.reshape(shape) for x in o))
        dv = JVec3(*(x.reshape(shape) for x in d))
        return jmk._intersect_candidates(
            ov, dv, jscene.sph, jscene.grp, jscene.gaabb,
            jax.numpy.ones(shape, bool), jscene.sph.shape[1])

    want_t, want_i = jax.jit(jax_walk)(o, d)
    want_t = np.asarray(want_t).reshape(-1)
    want_i = np.where(want_t < np.float32(3.4e38),
                      np.asarray(want_i).reshape(-1), -1)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert (want_i >= 0).sum() > n // 8   # the rays do hit spheres
    # XLA on the CPU fuses h*h - a*cc into one multiply-add; the cancellation
    # in q = h - sqrt(disc) magnifies that one rounding (2.2e-4 relative at
    # most on these rays, where |d| != 1).
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-3)
    # The full walk over every sphere finds the same hits, to the bit.
    all_t, all_i = mk._intersect_full(
        bt.Vec3(*map(torch.as_tensor, o)), bt.Vec3(*map(torch.as_tensor, d)),
        kscene, False, {"sphere_tests": 0, "slab_tests": 0})
    assert torch.equal(all_t, got_t) and torch.equal(all_i, got_i)


def test_duplicate_geometry_keeps_the_lower_index():
    """Rays at two spheres that the table holds twice: every walk of the
    plain version returns the lower index. (The JAX kernel's candidate walk
    does not always: its in-chunk tree reduce breaks exact ties by position,
    ROADMAP §C; its grouped and shortlist walks agree with the port, as the
    duplicates_split case above shows.)"""
    _, _, kscene, _ = _inputs(_grid4_duplicates(), 64, 64, cand_size=24)
    sph = kscene.sph.numpy()
    live = primary.live_mask(sph)
    pairs = [(i, j) for i in range(sph.shape[1]) for j in range(i + 1,
                                                                sph.shape[1])
             if live[i] and live[j] and (sph[:, i] == sph[:, j]).all()]
    assert len(pairs) == 2
    lo = torch.tensor([i for i, _ in pairs])
    cam = torch.tensor([0.0, 0.0, 5.0])
    o = bt.Vec3(*(cam[k].expand(2).clone() for k in range(3)))
    d = bt.Vec3(*(kscene.sph[k, lo] - cam[k] for k in range(3)))
    for candidates in (False, True):
        _, idx = mk._intersect_full(o, d, kscene, candidates,
                                    {"sphere_tests": 0, "slab_tests": 0})
        assert torch.equal(idx, lo)
    # A shortlist holding the higher index first.
    rows = [j for i, j in pairs] + [i for i, j in pairs]
    sl = torch.zeros(1, 5, 8)
    sl[0, 3] = -1e30
    sl[0, :4, :4] = kscene.sph[:, rows]
    sl[0, 4, :4] = torch.tensor(rows, dtype=torch.float32)
    meta = torch.tensor([[0.0, 0.0]])
    _, idx = mk._intersect_shortlist(o, d, sl, meta,
                                     torch.zeros(2, dtype=torch.long),
                                     {"sphere_tests": 0})
    assert torch.equal(idx, lo)


def test_work_counts_the_tests_the_best_hit_leaves():
    """The plain version counts the sphere tests that the rays' best hits
    leave (what chip_smoke.py's bound reads): a candidate group entered
    behind the best hit and a shortlist chunk whose t_lo lies behind it add
    none; a miss walks everything its ray enters."""
    # Nine unit spheres down the -z axis, 3 apart from z = 0; the rest of
    # the 16-sphere table is padding. Candidate groups of 8.
    z = torch.zeros(16)
    z[:9] = -3.0 * torch.arange(9.0)
    r2 = torch.full((16,), -1e30)
    r2[:9] = 1.0
    sph = torch.stack([torch.zeros(16), torch.zeros(16), z, r2])
    gaabb = torch.tensor([[-1.0, -1.0], [-1.0, -1.0], [-22.0, -25.0],
                          [1.0, 1.0], [1.0, 1.0], [1.0, -23.0]])
    kscene = mk.KernelScene(sph=sph, attr=torch.zeros(13, 16), gaabb=gaabb,
                            tri=torch.zeros(10, 0), gc=8, n_cand=2,
                            cand_off=0)
    # From z = 5: one ray down the axis (hits sphere 0 at t = 4), one up.
    o = bt.Vec3(torch.zeros(2), torch.zeros(2), torch.full((2,), 5.0))
    d = bt.Vec3(torch.zeros(2), torch.tensor([0.0, 1.0]),
                torch.tensor([-1.0, 0.0]))
    for candidates, tests in ((False, 2 * 16), (True, 8)):
        work = {"sphere_tests": 0, "slab_tests": 0}
        t, idx = mk._intersect_full(o, d, kscene, candidates, work)
        assert idx.tolist() == [0, -1] and float(t[0]) == 4.0
        assert work == {"sphere_tests": tests,
                        "slab_tests": 2 * 2 if candidates else 0}
    # The same spheres as one block's shortlist: two chunks, t_lo 4 and 28;
    # the axis ray stops after the first, the miss walks both (9 live rows).
    sl = torch.zeros(1, 5, 16)
    sl[0, :4] = sph
    sl[0, 4] = torch.arange(16.0)
    meta = torch.tensor([[0.0, 4.0 - 1e-3, 28.0 - 1e-3]])
    work = {"sphere_tests": 0}
    t, idx = mk._intersect_shortlist(o, d, sl, meta,
                                     torch.zeros(2, dtype=torch.long), work)
    assert idx.tolist() == [0, -1] and float(t[0]) == 4.0
    assert work == {"sphere_tests": 8 + 9}


def test_shortlist_input_checks():
    _, _, kscene, pcam = _inputs(jrtiow.simple_scene(), 16, 16)
    cfg = bt.RenderConfig(width=16, height=16, **SLICE)
    sl, meta = (torch.as_tensor(x) for x in _shortlists(kscene, pcam, cfg))
    for kwargs in (dict(sl=sl), dict(slmeta=meta),
                   dict(sl=sl[:, :4], slmeta=meta),
                   dict(sl=sl.double(), slmeta=meta),
                   dict(sl=sl, slmeta=meta[:, :1])):
        with pytest.raises(ValueError):
            mk.render_tiles(kscene, pcam, cfg, 1, **kwargs)
    with pytest.raises(ValueError, match="at most 32"):
        mk.render_tiles(kscene, pcam, dataclasses.replace(
            cfg, samples_per_pixel=33), 1, sl=sl, slmeta=meta)


def test_normalize_false_gives_sample_sums():
    _, _, kscene, pcam = _inputs(jrtiow.material_test_scene(), 32, 32)
    cfg = bt.RenderConfig(width=32, height=32, **SLICE)
    mean = mk.render_tiles(kscene, pcam, cfg, 3)
    sums = mk.render_tiles(kscene, pcam, cfg, 3, normalize=False)
    for m, s in zip(mean[:4], sums[:4]):
        np.testing.assert_allclose(s.numpy() * np.float32(0.5), m.numpy(),
                                   rtol=1e-6)
    assert int(mean[4]) == int(sums[4])


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and never builds or
    launches the CUDA kernel."""
    _, _, kscene, pcam = _inputs(jrtiow.simple_scene(), 16, 16)
    cfg = bt.RenderConfig(width=16, height=16, **SLICE)
    launches = mk.render_tiles.launches
    calls = mk.render_tiles_reference.calls
    got = mk.render_tiles(kscene, pcam, cfg, 1)
    want = mk.render_tiles_reference(kscene, pcam, cfg, 1)
    assert mk.render_tiles.launches == launches
    assert mk.render_tiles_reference.calls == calls + 2
    assert build._extension is None
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


@pytest.mark.parametrize("kwargs,blocks", [
    (dict(block_offset=1), slice(1, 4)),
    (dict(n_blocks_local=1), slice(0, 1)),
], ids=["block_offset", "n_blocks_local"])
def test_shard_offsets_slice_the_whole_frame(kwargs, blocks):
    """``block_offset`` alone renders as many blocks as the grid holds from
    that block (the last one lies past the grid: nothing traced there);
    ``n_blocks_local`` alone the first blocks. Each gives the whole frame's
    blocks to the bit."""
    _, _, kscene, pcam = _inputs(jrtiow.material_test_scene(), 128, 128)
    cfg = bt.RenderConfig(width=128, height=128, **SLICE)
    whole = mk.render_tiles(kscene, pcam, cfg, 1)
    got = mk.render_tiles(kscene, pcam, cfg, 1, **kwargs)
    lanes = slice(blocks.start * mk.TILE, blocks.stop * mk.TILE)
    n = blocks.stop - blocks.start
    for g, w in zip(got[:4], whole[:4]):
        assert torch.equal(g[:n * mk.TILE], w[lanes])
        assert not bool(g[n * mk.TILE:].any())
    assert 0 < int(got[4]) < int(whole[4])


SHARD = dict(samples_per_pixel=2, bounces=2, level=3)


@pytest.fixture(scope="module")
def shard_frame():
    """The material test scene at 128x192 (2 x 3 blocks), its split
    shortlists over the grid padded for 4 shards, and the whole frame's
    sums."""
    js, jcam, kscene, pcam = _inputs(jrtiow.material_test_scene(), 128, 192)
    cfg = bt.RenderConfig(width=128, height=192, pallas_primary="split",
                          pallas_intersect="candidates", **SHARD)
    sl, meta = primary.build_block_shortlists(kscene.sph.numpy(), pcam, cfg,
                                              n_blocks=8)
    sl, meta = torch.as_tensor(sl), torch.as_tensor(meta)
    whole = mk.render_tiles(kscene, pcam, cfg, 7, normalize=False, sl=sl[:6],
                            slmeta=meta[:6])
    return js, jcam, kscene, pcam, cfg, sl, meta, whole


@pytest.mark.parametrize("sp", [2, 4])
def test_shards_join_to_the_whole_frame(shard_frame, sp):
    """The grid's 6 blocks padded to a multiple of ``sp`` shards: the
    shards' outputs, joined, are the whole frame's to the bit, the padded
    blocks trace nothing, and their segments sum to the whole frame's."""
    _, _, kscene, pcam, cfg, sl, meta, whole = shard_frame
    local = -(-6 // sp)
    parts = [mk.render_tiles(kscene, pcam, cfg, 7, block_offset=i * local,
                             n_blocks_local=local, normalize=False,
                             sl=sl[i * local:(i + 1) * local],
                             slmeta=meta[i * local:(i + 1) * local])
             for i in range(sp)]
    for k in range(4):
        joined = torch.cat([p[k] for p in parts])
        assert torch.equal(joined[:6 * mk.TILE], whole[k])
        assert not bool(joined[6 * mk.TILE:].any())
    assert sum(int(p[4]) for p in parts) == int(whole[4])


def test_shard_offsets_match_jax(shard_frame):
    """Shard 1 of 2 (blocks 3-5) against JAX ``render_tiles`` with the same
    offsets, in interpret mode (off/grouped, the cheapest program to
    compile; every mode gives the same bits, and the split shards are held
    to the whole frame above)."""
    js, jcam, kscene, pcam, cfg, _, _, _ = shard_frame
    cfg = dataclasses.replace(cfg, pallas_primary="off",
                              pallas_intersect="grouped")
    run = dict(block_offset=3, n_blocks_local=3, normalize=False)
    want = jmk.render_tiles(
        jmk.jitted_prepare(0, "kd")(js), jcam,
        JRenderConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)}),
        np.uint32(7), exact_rng=True, **run)
    got = mk.render_tiles(kscene, pcam, cfg, 7, **run)
    # Sums of 2 samples, held at the per-spp bars.
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy() / 2, np.asarray(w) / 2,
                                   atol=5e-5)
    np.testing.assert_allclose(got[3].numpy() / 2, np.asarray(want[3]) / 2,
                               atol=1e-3)
    assert int(got[4]) == int(want[4]) > 0


def test_shard_input_checks():
    _, _, kscene, pcam = _inputs(jrtiow.simple_scene(), 16, 16)
    cfg = bt.RenderConfig(width=16, height=16, **SLICE)
    for kwargs in (dict(block_offset=-1), dict(block_offset=1.0),
                   dict(n_blocks_local=0), dict(n_blocks_local=True)):
        with pytest.raises(ValueError, match="block_offset|n_blocks_local"):
            mk.render_tiles(kscene, pcam, cfg, 1, **kwargs)
    sl, meta = (torch.as_tensor(x) for x in _shortlists(kscene, pcam, cfg))
    with pytest.raises(ValueError, match=r"\(2, 5, K\)"):
        mk.render_tiles(kscene, pcam, cfg, 1, n_blocks_local=2, sl=sl,
                        slmeta=meta)


def test_fuse_resolves_from_the_local_block_count():
    """As the JAX kernel's: 510 headline blocks in 3 shards of 170 keep fuse
    4 under "auto" (2 padded tail halves, within 1/12); a shard of 3
    blocks takes none."""
    scene = mk.KernelScene(sph=torch.zeros(4, 512), attr=torch.zeros(13, 512),
                           gaabb=torch.zeros(6, 1), tri=torch.zeros(10, 0),
                           gc=16, n_cand=32, cand_off=0, has_emissive=False)
    cfg = bt.RenderConfig(width=1920, height=1080, samples_per_pixel=16)
    jcfg = JRenderConfig(width=1920, height=1080, samples_per_pixel=16)
    assert jmk.block_grid(jcfg) == mk.block_grid(cfg)
    old = jmk.PHASE_FUSE
    jmk.PHASE_FUSE = mk.PHASE_FUSE    # the shipped "auto" (tests run fuse 1)
    try:
        for local in (None, 170, 128, 3):
            n = 510 if local is None else local
            want = jmk._resolve_fuse(n, 16, True, 512, 10)
            assert mk.kernel_fuse(scene, cfg, 1, local) == want
    finally:
        jmk.PHASE_FUSE = old
    assert mk.kernel_fuse(scene, cfg, 1, 170) == 4
    assert mk.kernel_fuse(scene, cfg, 1, 3) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("scene_fn,options", [
    (lambda: bt.rtiow.final_scene(seed=42, grid=4), {}),
    (lambda: bt.rtiow.final_scene(seed=42, grid=4), dict(level=1)),
    (bt.rtiow.night_scene, {}),
    (lambda: bt.rtiow.material_test_scene(bt.RaytracedCamera(**LENS)),
     dict(defocus=True, diffuse_sampling="cosine")),
    (lambda: bt.rtiow.final_scene(seed=42, grid=4),
     dict(pallas_primary="split", pallas_intersect="candidates",
          pallas_cand_size=8)),
    (lambda: bt.rtiow.final_scene(seed=42, grid=4),
     dict(pallas_primary="split", pallas_intersect="grouped")),
    (lambda: bt.rtiow.final_scene(seed=42, grid=4),
     dict(pallas_intersect="candidates")),
    (lambda: bt.rtiow.final_scene(seed=42),
     dict(pallas_primary="split", pallas_intersect="auto",
          pallas_cand_size=8)),
    (lambda: _with_duplicates(bt.rtiow.final_scene(seed=42, grid=4), bt),
     dict(pallas_primary="split", pallas_intersect="candidates",
          pallas_cand_size=24)),
], ids=["final", "final_level1", "night", "defocus_cosine", "split_candidates",
        "split_grouped", "off_candidates", "multiword_auto",
        "duplicates_gc24"])
def test_cuda_kernel_matches_plain_version_on_card(scene_fn, options):
    """On the card: the kernel against its plain version on the same CUDA
    tensors, color and depth, in every mode (the bars of chip_smoke.py
    phase 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    world = scene_fn()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(bt.RenderConfig(width=128, height=128, **SLICE),
                              samples_per_pixel=4, **options)
    kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False, device=dev),
                                     cfg.pallas_cand_size)
    cam = world.camera_state(aspect=1.0, device=dev)
    sl, slmeta = primary.device_shortlists_for(kscene, cam, cfg, 4)
    assert (sl is not None) == (cfg.pallas_primary == "split")
    launches = mk.render_tiles.launches
    got = mk.render_tiles(kscene, cam, cfg, 7, sl=sl, slmeta=slmeta)
    want = mk.render_tiles_reference(kscene, cam, cfg, 7, sl=sl, slmeta=slmeta)
    assert mk.render_tiles.launches == launches + 1
    diff = torch.stack([(g - w).abs() for g, w in zip(got[:3], want[:3])])
    assert float((diff.amax(0) <= 1e-3).float().mean()) >= 0.999
    assert float(diff.mean()) < 5e-5
    depth = (got[3] - want[3]).abs()
    assert float((depth <= 1e-3).float().mean()) >= 0.999
    assert float(depth.mean() / want[3].abs().mean()) < 1e-4
    assert abs(int(got[4]) - int(want[4])) <= 1e-3 * int(want[4])


# The unsplit full walk (off/grouped), whose threads take each pixel from
# the launch's counter: (scene, width, height, config options, render_tiles
# options); a sample map is drawn from the seed for "spp_map".
FULL_WALK = dict(pallas_primary="off", pallas_intersect="grouped", level=3)
FULL_WALK_CASES = {
    # more samples than the split takes, the lens, 13-deep paths
    "over_32_spp_lens": (
        lambda: bt.rtiow.material_test_scene(bt.RaytracedCamera(**LENS)),
        64, 64, dict(samples_per_pixel=40, bounces=12, defocus=True), {}),
    # 128 blocks, 2,048 units: several pixels a thread of the 528-block grid
    "pixels_over_threads": (lambda: bt.rtiow.final_scene(seed=42, grid=4),
                            1024, 512, dict(samples_per_pixel=32, bounces=4),
                            {}),
    # 2 blocks, 32 units: a grid of fewer blocks than the card holds, both
    # blocks partly outside the frame
    "units_under_blocks": (bt.rtiow.night_scene, 96, 60,
                           dict(samples_per_pixel=40, bounces=6), {}),
    # the second of two shards of 3 blocks
    "shard": (lambda: bt.rtiow.final_scene(seed=42, grid=4), 128, 192,
              dict(samples_per_pixel=32, bounces=4),
              dict(block_offset=3, n_blocks_local=3, normalize=False)),
    # targets 0-40 at a sample offset, some within the pilot's samples,
    # target-0 lanes written as zeros
    "spp_map": (lambda: bt.rtiow.final_scene(seed=42, grid=4), 192, 100,
                dict(samples_per_pixel=40, bounces=4),
                dict(spp_map=True, sample_offset=32, normalize=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FULL_WALK_CASES))
@pytest.mark.parametrize("exact_rng", [True, False], ids=["exact", "fast"])
def test_cuda_full_walk_matches_plain_version_on_card(case, exact_rng):
    """On the card: the off/grouped kernel, whose threads take their pixels
    from the launch's counter, in its pilot and main launches (the main one
    continues the pilot's sums, costliest pixels first), bit-equal to its
    plain version with equal segments, and on the fast draws its probe
    instance to the default instance (a shard has no probe launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    scene_fn, width, height, options, run = FULL_WALK_CASES[case]
    dev = torch.device("cuda", 0)
    cfg = bt.RenderConfig(width=width, height=height, **FULL_WALK, **options)
    world = scene_fn()
    kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False, device=dev))
    cam = world.camera_state(aspect=width / height, device=dev)
    assert mk.kernel_mode(kscene, cfg, None) == ("off", "grouped")
    run = dict(run, exact_rng=exact_rng)
    assert mk.pilot_samples(("off", "grouped"),
                            cfg.samples_per_pixel) == mk.PILOT_SPP
    if run.get("spp_map"):
        targets = np.random.default_rng(3).integers(0, 41, width * height)
        run["spp_map"] = mk.shuffle_blocks(
            torch.as_tensor(targets, dtype=torch.int32), cfg).to(dev)
    n_tiles = mk.local_blocks(cfg, run.get("n_blocks_local"))
    info = mk.instance_info(dev, False, False, not exact_rng, 1, 0)
    grid = mk.persistent_grid(n_tiles, info["blocks_per_sm"], info["n_sms"])
    threads, units = grid * 256, n_tiles * mk.SLICES
    if case == "pixels_over_threads":
        assert width * height > 3 * threads
    if case == "units_under_blocks":
        assert grid == units < info["blocks_per_sm"] * info["n_sms"]
    got = mk.render_tiles(kscene, cam, cfg, 7, **run)
    want = mk.render_tiles_reference(kscene, cam, cfg, 7, **run)
    _bit_equal(got, want)
    # The pilot alone: the plain version's unnormalised sums and segments for
    # its samples, each lane's segments in its cost, whose sum is the
    # launch's count.
    pilot_cfg = dataclasses.replace(cfg, samples_per_pixel=mk.PILOT_SPP)
    pilot_run = dict(run, normalize=False)
    cost = torch.zeros(n_tiles * mk.TILE, dtype=torch.int32, device=dev)
    pilot = mk._launch(kscene, cam, cfg, 7, exact_rng,
                       run.get("block_offset", 0), run.get("sample_offset", 0),
                       n_tiles, False, None, None, run.get("spp_map"),
                       mk.kernel_fuse(kscene, cfg, None,
                                      run.get("n_blocks_local")),
                       spp=mk.PILOT_SPP, cost=cost)
    _bit_equal(pilot, mk.render_tiles_reference(kscene, cam, pilot_cfg, 7,
                                                **pilot_run))
    assert int(cost.sum()) == int(pilot[4])
    if run.get("spp_map") is not None:
        idle = run["spp_map"].reshape(-1) == 0
        assert bool(idle.any())
        for out in got[:4]:
            assert not bool(out[idle].any())
    if exact_rng or "block_offset" in run:
        return
    extra = {k: run[k] for k in ("spp_map", "sample_offset", "normalize")
             if k in run}
    probed, clk = mk.render_tiles_probe(kscene, cam, cfg, 7, **extra)
    _bit_equal(probed, got)
    # The probe's clocks are the main launch's: its segments that launch's
    # count, which with the pilot's makes the frame's.
    assert clk["launch_segments"] == [int(pilot[4]), clk["segments"]]
    assert sum(clk["launch_segments"]) == int(want[4])
    assert clk["stage"] == 0 and clk["walk0"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("exact_rng", [True, False], ids=["exact", "fast"])
def test_cuda_shards_match_plain_version_on_card(exact_rng):
    """On the card: the kernel with the shard offsets against its plain
    version, 128x192 in 2 shards under fuse 2, so each shard's fused tail
    half aliases the other shard's block (chip_smoke.py phase 8(a))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    world = bt.rtiow.material_test_scene()
    dev = torch.device("cuda", 0)
    cfg = bt.RenderConfig(width=128, height=192, **SHARD)
    kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False, device=dev))
    cam = world.camera_state(aspect=128 / 192, device=dev)
    old = mk.PHASE_FUSE
    mk.PHASE_FUSE = 2
    try:
        total = 0
        for i in range(2):
            sl, slmeta = primary.device_shortlists_for(
                kscene, cam, dataclasses.replace(cfg, pallas_primary="split"),
                2, block_lo=3 * i, n_blocks=3)
            run = dict(exact_rng=exact_rng, block_offset=3 * i,
                       n_blocks_local=3, normalize=False, sl=sl,
                       slmeta=slmeta)
            assert mk.kernel_fuse(kscene, cfg, sl, 3) == 2
            got = mk.render_tiles(kscene, cam, cfg, 7, **run)
            want = mk.render_tiles_reference(kscene, cam, cfg, 7, **run)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            total += int(got[4])
        whole = mk.render_tiles(kscene, cam, cfg, 7, exact_rng=exact_rng)
        assert total == int(whole[4])
    finally:
        mk.PHASE_FUSE = old


@pytest.mark.parametrize("n_tiles,fuse,grid", [
    (510, 4, 528), (510, 1, 528), (240, 4, 528), (170, 4, 528), (3, 2, 48),
    (6, 8, 96), (1, 1, 16)])
@pytest.mark.parametrize("sampled", [False, True], ids=["dense", "sampled"])
def test_work_items_partition_the_units(n_tiles, fuse, grid, sampled):
    """The items of the headline, its unfused grid, BASELINE config 5, a
    (3,1) shard of the headline and small launches: consecutive unit ranges
    that cover every unit of the local blocks once (no padded half). Without
    a sample map each is one unit; under one none crosses a run of ``fuse``
    blocks, none is larger than 1 / (GUIDE x grid) of the units left but
    one unit, and the last ones are one unit each."""
    items = mk.work_items(n_tiles, fuse, grid, sampled)
    n_units, run = n_tiles * mk.SLICES, fuse * mk.SLICES
    assert items[0][0] == 0 and items[-1][1] == n_units
    assert all(a[1] == b[0] for a, b in zip(items, items[1:]))
    for lo, hi in items:
        assert 1 <= hi - lo <= max((n_units - lo) // (mk.GUIDE * grid), 1)
        assert lo // run == (hi - 1) // run
    assert items[-1][1] - items[-1][0] == 1
    if not sampled:
        assert len(items) == n_units
    elif n_units >= 4 * mk.GUIDE * grid:
        assert len(items) < n_units
    assert mk.SLICES * 256 == mk.TILE


@pytest.mark.parametrize("n_tiles,block_offset,nbx,width,height", [
    (209, 0, 19, 1200, 675), (510, 0, 30, 1920, 1080), (3, 3, 2, 128, 192),
    (2, 0, 2, 96, 60), (1, 0, 1, 40, 30)],
    ids=["book", "headline", "second_shard", "two_blocks", "one_block"])
def test_full_walk_counter_names_each_lane_once(n_tiles, block_offset, nbx,
                                                width, height):
    """The full walk's threads take pixels from the launch's counter: value
    k names local lane k, in local block k // TILE, whose global block
    ``block_offset`` + local holds the pixel; the launch's values cover each
    of its lanes once, and so each pixel of the frame in its global blocks
    once. The book's frame, the headline, a shard and frames partly outside
    their blocks."""
    k = torch.arange(n_tiles * mk.TILE)
    blk, r, px, py = mk.item_pixels(k, 0, block_offset, nbx)
    assert torch.equal(blk * mk.TILE + r, k)
    assert torch.equal(px // mk.BLOCK_W + py // mk.BLOCK_H * nbx,
                       block_offset + blk)
    inside = (px < width) & (py < height)
    ids = py[inside] * width + px[inside]
    assert ids.unique().numel() == ids.numel()
    yy, xx = torch.meshgrid(torch.arange(height), torch.arange(width),
                            indexing="ij")
    block = xx // mk.BLOCK_W + yy // mk.BLOCK_H * nbx
    mine = (block >= block_offset) & (block < block_offset + n_tiles)
    assert torch.equal(ids.sort().values, (yy * width + xx)[mine].sort().values)


@pytest.mark.parametrize("n_tiles,fuse,grid", [
    (209, 1, 528), (170, 4, 528), (6, 8, 96), (3, 2, 48)])
@pytest.mark.parametrize("sampled", [False, True], ids=["dense", "sampled"])
def test_work_items_take_the_lanes_the_counter_names(n_tiles, fuse, grid,
                                                     sampled):
    """The split and candidate instances' work items, each's pixels in the
    order its threads take them, name the launch's lanes in the order the
    full walk's counter values do: a counter value names the same local
    lane, block and pixel in every instance."""
    lanes = []
    for lo, hi in mk.work_items(n_tiles, fuse, grid, sampled):
        blk, r, _, _ = mk.item_pixels(torch.arange((hi - lo) * 256), lo, 0, 1)
        lanes.append(blk * mk.TILE + r)
    assert torch.equal(torch.cat(lanes), torch.arange(n_tiles * mk.TILE))


@pytest.mark.parametrize("mode,spp,want", [
    (("off", "grouped"), 500, mk.PILOT_SPP),
    (("off", "grouped"), 4 * mk.PILOT_SPP, mk.PILOT_SPP),
    (("off", "grouped"), 4 * mk.PILOT_SPP - 1, 0),
    (("off", "grouped"), 2, 0),
    (("off", "candidates"), 500, 0),
    (("split", "grouped"), 500, 0),
    (("split", "candidates"), 16, 0)])
def test_pilot_only_for_the_full_walk_at_many_samples(mode, spp, want):
    """The full walk alone takes a pilot launch, and only where its
    PILOT_SPP samples are at most a quarter of the frame's: the book's 500,
    not the headline's 16 or a mode with work items."""
    assert mk.pilot_samples(mode, spp) == want


@pytest.mark.parametrize("nbx,nby,n_tiles,block_offset", [
    (2, 1, 2, 0), (3, 2, 6, 0), (3, 2, 2, 3)],
    ids=["two_blocks", "six_blocks", "shard"])
def test_walk_order_takes_the_costliest_pixels_first(nbx, nby, n_tiles,
                                                     block_offset):
    """The main launch's order: a permutation of the local lanes by the
    pilot's counts averaged over each pixel's 3x3 neighbours in the padded
    frame (those inside it, across block edges; other shards' lanes count
    0), the costliest first, ties in block order; held against a twin that
    averages each neighbourhood exactly, on counts whose means are whole."""
    gen = torch.Generator().manual_seed(5 + n_tiles)
    cost = 36 * torch.randint(0, 50, (n_tiles * mk.TILE,), generator=gen,
                              dtype=torch.int32)
    order = mk.walk_order(cost, nbx, nby, block_offset)
    assert order.dtype == torch.int32
    assert torch.equal(order.long().sort().values,
                       torch.arange(n_tiles * mk.TILE))
    _, _, px, py = mk.item_pixels(torch.arange(n_tiles * mk.TILE), 0,
                                  block_offset, nbx)
    width, height = nbx * mk.BLOCK_W, nby * mk.BLOCK_H
    image = np.zeros((height, width), dtype=np.int64)
    image[py.numpy(), px.numpy()] = cost.numpy()
    means = []
    for x, y in zip(px.tolist(), py.tolist()):
        box = image[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
        assert int(box.sum()) % box.size == 0
        means.append(int(box.sum()) // box.size)
    want = sorted(range(len(means)), key=lambda k: -means[k])
    assert order.tolist() == want


def test_walk_order_ranks_a_costly_patch_above_a_lone_costly_pixel():
    """One pixel that the pilot found costly among cheap neighbours ranks
    below a patch of slightly cheaper pixels: its neighbours' counts say the
    few samples overrated it."""
    cost = torch.full((mk.TILE,), 8, dtype=torch.int32)
    lone = 10 * mk.BLOCK_W + 10
    cost[lone] = 90
    patch = [(40 + dy) * mk.BLOCK_W + 40 + dx for dy in (-1, 0, 1)
             for dx in (-1, 0, 1)]
    cost[patch] = 60
    order = mk.walk_order(cost, 1, 1).tolist()
    assert order[0] == patch[4]
    assert order.index(lone) > max(order.index(k) for k in patch)


def test_persistent_grid_fills_the_card_or_the_work():
    """The grid is the resident blocks the card holds at once, or one block
    per unit where there are fewer; an instance that fits on no SM
    raises."""
    assert mk.persistent_grid(510, 4, 132) == 528
    assert mk.persistent_grid(3, 4, 132) == 48
    with pytest.raises(ValueError, match="does not fit"):
        mk.persistent_grid(510, 0, 132)


def test_probe_slots_follow_the_kernel_header():
    """The wrapper names the probe's sums in the order of the kernel's
    ``ProbeSlot`` enum (csrc/megakernel.h)."""
    import re
    from pathlib import Path

    header = (Path(mk.__file__).parent / "csrc" / "megakernel.h").read_text()
    body = re.search(r"enum ProbeSlot \{(.*?)\};", header, re.S).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kProbeSlots"
    snake = [re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", n[len("kProbe"):]).lower()
             for n in names[:-1]]
    assert tuple(snake) == mk.PROBE_SLOTS


def test_box_stage_holds_every_candidate_group():
    """The candidate instances stage every group's box in shared memory,
    sized by ``kMaxCandGroups`` (csrc/megakernel.h): as many groups as the
    scene tables allow, 31 x MAX_CAND_WORDS; a table that would need more
    is refused before any launch."""
    import re
    from pathlib import Path

    header = (Path(mk.__file__).parent / "csrc" / "megakernel.h").read_text()
    a, b = re.search(r"constexpr int kMaxCandGroups = (\d+) \* (\d+);",
                     header).groups()
    assert int(a) * int(b) == 31 * mk.MAX_CAND_WORDS
    scene = bt.rtiow.final_scene(seed=42).extract(with_bvh=False,
                                                  device="cpu")
    assert mk.prepare_kernel_scene(scene).n_cand == 32
    big = bt.rtiow.final_scene(seed=42, grid=20).extract(with_bvh=False,
                                                         device="cpu")
    assert mk.prepare_kernel_scene(big).n_cand <= 31 * mk.MAX_CAND_WORDS
    with pytest.raises(ValueError, match="candidate groups"):
        mk.prepare_kernel_scene(big, 8)


# The helpers side by side in one small kernel, bound with ctypes.
_NAN_MIN_MAX_SHIM = r"""
#include "common.cuh"

__global__ void nan_min_max(const float* x, const float* y, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = min_nan1(x[i], y[i]);
  out[n + i] = max_nan1(x[i], y[i]);
  out[2 * n + i] = min2_nan(x[i], y[i]);
  out[3 * n + i] = max2_nan(x[i], y[i]);
}

extern "C" int nan_min_max_run(const float* x, const float* y, float* out, int n) {
  nan_min_max<<<(n + 255) / 256, 256>>>(x, y, out, n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


@pytest.mark.cuda
def test_cuda_one_instruction_nan_min_max_match_the_helpers(tmp_path):
    """On the card: ``min_nan1`` / ``max_nan1`` (common.cuh, one FMNMX with
    the NaN flag each) against ``min2_nan`` / ``max2_nan`` on every pair of
    +-0, +-denormals, +-1, +-f32 max, +-inf and NaNs, and on 10^6 pairs of
    random bit patterns: the same bits wherever the old helper's result is
    not NaN, and NaN wherever it is. Built with the kernels' flags
    (build.CUDA_FLAGS: --fmad=false, no fast math)."""
    import ctypes
    import shutil
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the kernel there")
    from pathlib import Path

    csrc = Path(mk.__file__).parent / "csrc"
    (tmp_path / "shim.cu").write_text(_NAN_MIN_MAX_SHIM)
    lib = tmp_path / "libnanminmax.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *build.CUDA_FLAGS, "-std=c++17", "-shared",
                    "-Xcompiler", "-fPIC", f"-I{csrc}", "-o", str(lib),
                    str(tmp_path / "shim.cu")], check=True, timeout=300)
    run = ctypes.CDLL(str(lib)).nan_min_max_run
    run.restype = ctypes.c_int

    special = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001,
                        0x007FFFFF, 0x807FFFFF, 0x3F800000, 0xBF800000,
                        0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000,
                        0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FBFFFFF],
                       dtype=np.uint32)
    sx, sy = np.meshgrid(special, special, indexing="ij")
    rng = np.random.default_rng(20231)
    bits_x = np.concatenate([sx.ravel(), rng.integers(
        0, 2**32, 10**6, dtype=np.uint64).astype(np.uint32)])
    bits_y = np.concatenate([sy.ravel(), rng.integers(
        0, 2**32, 10**6, dtype=np.uint64).astype(np.uint32)])
    dev = torch.device("cuda", 0)
    x = torch.as_tensor(bits_x.view(np.float32)).to(dev)
    y = torch.as_tensor(bits_y.view(np.float32)).to(dev)
    n = x.numel()
    out = torch.empty(4 * n, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    assert run(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
               ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n)) == 0
    res = out.cpu().numpy().reshape(4, n)
    bits = res.view(np.uint32)
    assert np.isnan(bits_x.view(np.float32)).any()
    for new, old in ((0, 2), (1, 3)):
        nan = np.isnan(res[old])
        assert np.array_equal(bits[new][~nan], bits[old][~nan])
        assert np.isnan(res[new][nan]).all()
        # The helpers are the minimum / maximum: checked against NumPy's
        # (which keeps NaN) on the pairs of distinct values.
        want = (np.minimum if new == 0 else np.maximum)(
            bits_x.view(np.float32), bits_y.view(np.float32))
        distinct = ~nan & (bits_x.view(np.float32) != bits_y.view(np.float32))
        assert np.array_equal(res[new][distinct], want[distinct])
        assert np.isnan(want[nan]).all()


def test_probe_takes_cuda_tensors_only():
    """The probe measures the CUDA kernel: on CPU tensors it raises, and the
    extension is not built."""
    _, _, kscene, pcam = _inputs(jrtiow.simple_scene(), 16, 16)
    cfg = bt.RenderConfig(width=16, height=16, **SLICE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.render_tiles_probe(kscene, pcam, cfg, 1)
    assert build._extension is None


def _card_scene(world, width, height, spp=4, **options):
    """A scene, camera, config and shortlists on the card."""
    dev = torch.device("cuda", 0)
    cfg = bt.RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=4, level=3, pallas_primary="split",
                          pallas_intersect="candidates", **options)
    kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False, device=dev))
    cam = world.camera_state(aspect=width / height, device=dev)
    sl, slmeta = primary.device_shortlists_for(kscene, cam, cfg, spp)
    return kscene, cam, cfg, sl, slmeta


def _bit_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [1, 2, 4, 8])
@pytest.mark.parametrize("exact_rng", [True, False], ids=["exact", "fast"])
def test_cuda_persistent_kernel_every_fuse(fuse, exact_rng):
    """On the card: the persistent kernel against its plain version at
    192x128 (6 blocks, so fuses 4 and 8 pad their tail item), bit-equal
    with equal segments, on both draw paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    kscene, cam, cfg, sl, slmeta = _card_scene(bt.rtiow.final_scene(seed=42),
                                               192, 128)
    old = mk.PHASE_FUSE
    mk.PHASE_FUSE = fuse
    try:
        assert mk.kernel_fuse(kscene, cfg, sl) == fuse
        run = dict(exact_rng=exact_rng, sl=sl, slmeta=slmeta)
        _bit_equal(mk.render_tiles(kscene, cam, cfg, 7, **run),
                   mk.render_tiles_reference(kscene, cam, cfg, 7, **run))
    finally:
        mk.PHASE_FUSE = old


@pytest.mark.cuda
def test_cuda_shard_with_padded_tail_under_fuse_4():
    """On the card: 2 shards of 3 blocks of a mesh scene under fuse 4, so
    each shard's one item pads a half that would be the other shard's
    block; each shard bit-equal to its plain version, and their segments
    sum to the whole frame's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    world = bt.rtiow.simple_scene()
    world.spawn_mesh(bt.Transform.from_xyz(0.3, 0.4, 1.0), bt.cube_mesh(0.5),
                     bt.StandardMaterial(base_color=(0.9, 0.6, 0.2),
                                         metallic=1.0))
    kscene, cam, cfg, sl, slmeta = _card_scene(world, 128, 192, spp=2)
    old = mk.PHASE_FUSE
    mk.PHASE_FUSE = 4
    try:
        total = 0
        for i in range(2):
            run = dict(exact_rng=False, block_offset=3 * i, n_blocks_local=3,
                       normalize=False, sl=sl[3 * i:3 * i + 3],
                       slmeta=slmeta[3 * i:3 * i + 3])
            assert mk.kernel_fuse(kscene, cfg, sl, 3) == 4
            got = mk.render_tiles(kscene, cam, cfg, 7, **run)
            _bit_equal(got, mk.render_tiles_reference(kscene, cam, cfg, 7,
                                                      **run))
            total += int(got[4])
        assert total == int(mk.render_tiles(kscene, cam, cfg, 7, sl=sl,
                                            slmeta=slmeta)[4])
    finally:
        mk.PHASE_FUSE = old


@pytest.mark.cuda
def test_cuda_zero_targets_and_a_partial_block_row():
    """On the card: 192x100, whose last block row lies partly outside the
    frame, under a sample map with targets 0-4 at a sample offset: sums
    bit-equal to the plain version's, and every lane of target 0 or outside
    the frame written as exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    kscene, cam, cfg, sl, slmeta = _card_scene(bt.rtiow.final_scene(seed=42),
                                               192, 100)
    targets = np.random.default_rng(3).integers(0, 5, 192 * 100)
    spp_map = mk.shuffle_blocks(torch.as_tensor(targets, dtype=torch.int32),
                                cfg).to(kscene.sph.device)
    run = dict(exact_rng=False, sl=sl, slmeta=slmeta, spp_map=spp_map,
               sample_offset=32, normalize=False)
    got = mk.render_tiles(kscene, cam, cfg, 7, **run)
    _bit_equal(got, mk.render_tiles_reference(kscene, cam, cfg, 7, **run))
    idle = spp_map.reshape(-1) == 0
    assert int(idle.sum()) > 6 * mk.TILE - 192 * 100
    for out in got[:4]:
        assert not bool(out[idle].any())


@pytest.mark.cuda
def test_cuda_back_to_back_launches_take_fresh_counters():
    """On the card: two launches queued back to back, and then the probe
    instance, each see a fresh work counter: the same bits and segment
    count as the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    kscene, cam, cfg, sl, slmeta = _card_scene(bt.rtiow.final_scene(seed=42),
                                               192, 128)
    run = dict(exact_rng=False, sl=sl, slmeta=slmeta)
    first = mk.render_tiles(kscene, cam, cfg, 7, **run)
    second = mk.render_tiles(kscene, cam, cfg, 7, **run)
    probed, clocks = mk.render_tiles_probe(kscene, cam, cfg, 7, sl=sl,
                                           slmeta=slmeta)
    want = mk.render_tiles_reference(kscene, cam, cfg, 7, **run)
    for got in (first, second, probed):
        _bit_equal(got, want)
    assert clocks["segments"] == int(want[4])
    assert 0 < clocks["issues"] <= clocks["segments"]
