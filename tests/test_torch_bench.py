"""The port's benches (``bevyray_tpu_torch/bench/``) against the JAX
repository's bench scripts, and each bench run at a tiny size on the CPU.

The JAX scripts are read, never edited: ``scripts/bench_orbit.py`` is loaded
with importlib for its ``orbit_cams``; the other recipes (the edit draws,
the five BASELINE configs) are rebuilt here with the JAX package's classes,
line for line. Each bench's frames are held to a direct ``FusedRenderer``
render of the same scene, camera and seed (bit-equal), and its ray counts
to those frames' ``rays_traced``. The host copies that keep the fused
path's host work from waiting for the card (``core.types.upload``,
``host_array``, ``camera_key``) are held to the tensors they mirror.
"""

import ast
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.scene.components import cube_mesh as jax_cube_mesh
from bevyray_tpu_torch.bench import edit, headline, matrix, orbit, scaling
from bevyray_tpu_torch.core.types import (camera_key, camera_leaves,
                                          host_array, host_camera,
                                          resolve_device, upload)
from bevyray_tpu_torch.engine.fused_renderer import FusedRenderer
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.kernels.cuda.grouping import cached_order

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(width=32, height=18, spp=1)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_keys(path):
    """The JSON keys a JAX bench script prints: the string keys of its dict
    literals (both arms of a conditional key) and the keyword names of its
    ``record(...)`` calls."""
    keys = set()
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                consts = ([k] if isinstance(k, ast.Constant) else
                          [k.body, k.orelse] if isinstance(k, ast.IfExp)
                          else [])
                keys |= {c.value for c in consts
                         if isinstance(c, ast.Constant)}
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "record"):
            keys |= {kw.arg for kw in node.keywords if kw.arg}
    return keys


def _printed_keys(text):
    """Every key, nested ones too, of the JSON lines in ``text``."""
    keys = set()

    def walk(obj):
        if isinstance(obj, dict):
            keys.update(obj)
            for v in obj.values():
                walk(v)

    for line in text.splitlines():
        if line.startswith("{"):
            walk(json.loads(line))
    return keys


def _bits(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint8)


@pytest.fixture
def recorded(monkeypatch):
    """Every ``FusedRenderer.render`` call of the test, with its frame."""
    calls = []
    render = FusedRenderer.render

    def recording(self, scene, cam, seed, raster_color=None,
                  raster_depth=None):
        frame = render(self, scene, cam, seed, raster_color, raster_depth)
        calls.append((self.config, scene, cam, seed, raster_color,
                      raster_depth, frame))
        return frame

    monkeypatch.setattr(FusedRenderer, "render", recording)
    return calls, render


def _check_direct(recorded):
    """Each recorded frame bit-equal to a direct render of a fresh
    ``FusedRenderer`` on the same inputs; returns the segments of each
    frame by (id of its scene, seed), in call order."""
    calls, render = recorded
    assert calls
    rays = {}
    for config, scene, cam, seed, rc, rd, frame in calls:
        want = render(FusedRenderer(config), scene, cam, seed, rc, rd)
        np.testing.assert_array_equal(_bits(frame.image), _bits(want.image))
        np.testing.assert_array_equal(_bits(frame.rt_depth),
                                      _bits(want.rt_depth))
        assert int(frame.rays_traced) == int(want.rays_traced) > 0
        rays.setdefault((id(scene), seed), []).append(int(frame.rays_traced))
    return rays


# -- the recipes against the JAX scripts -------------------------------------

def test_orbit_cams_match_jax_script():
    jax_orbit = _load_script("bench_orbit")
    jcams = jax_orbit.orbit_cams(jb.rtiow.final_scene(seed=42), 5, 16 / 9)
    pcams = orbit.orbit_cams(bt.rtiow.final_scene(seed=42), 5, 16 / 9,
                             device="cpu")
    assert len(jcams) == len(pcams) == 5
    for jc, pc in zip(jcams, pcams):
        want = np.array([np.asarray(v, np.float32)
                         for v in jax.tree.leaves(jc)])
        got = np.array([v.numpy() for v in camera_leaves(pc)], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_edit_sequence_matches_jax_recipe():
    """``default_rng(7)`` edits (scripts/bench_orbit.py:135-141,
    scripts/bench_edit.py:64-72) on both packages' worlds: equal sphere and
    material tables after every edit."""
    jworld = jb.rtiow.final_scene(seed=42)
    pworld = bt.rtiow.final_scene(seed=42)
    rng = np.random.default_rng(7)
    apply_edit = orbit.edit_sequence(pworld, "cpu")
    for i in range(4):
        eid = int(rng.integers(0, jworld.n_spheres))
        jworld.set_translation(eid, (float(rng.uniform(-8, 8)), 0.2,
                                     float(rng.uniform(-8, 8))))
        js = jworld.extract(with_bvh=False)
        ps = apply_edit(i)
        for table in ("spheres", "materials"):
            for name in getattr(js, table)._fields:
                np.testing.assert_array_equal(
                    getattr(getattr(ps, table), name).numpy(),
                    np.asarray(getattr(getattr(js, table), name)),
                    err_msg=f"edit {i}: {table}.{name}")


def _jax_matrix_recipe():
    """(world, RenderConfig, aspect) of scripts/bench_matrix.py:55-114, in
    the JAX package."""
    R = jb.RenderConfig
    cube = jb.rtiow.final_scene(seed=42)
    cube.spawn_mesh(jb.Transform.from_xyz(-4.0, 0.6, 1.0),
                    jax_cube_mesh(1.2),
                    jb.StandardMaterial(base_color=(0.2, 0.5, 0.9),
                                        metallic=1.0,
                                        perceptual_roughness=0.15))
    night = jb.rtiow.night_scene(camera=jb.RaytracedCamera(
        level=jb.Raytracing.PURE, aperture=0.15, focus_distance=6.0))
    return [
        (jb.rtiow.simple_scene(), R(width=256, height=256,
                                    samples_per_pixel=4, bounces=8, level=3),
         1.0),
        (jb.rtiow.material_test_scene(),
         R(width=512, height=512, samples_per_pixel=16, bounces=8, level=3),
         1.0),
        (jb.rtiow.final_scene(seed=42),
         R(width=1280, height=720, samples_per_pixel=16, bounces=4, level=3),
         16 / 9),
        (night, R(width=1920, height=1080, samples_per_pixel=4, bounces=4,
                  level=3, defocus=True, diffuse_sampling="cosine"), 16 / 9),
        (cube, R(width=1280, height=720, samples_per_pixel=16, bounces=4,
                 level=2), 16 / 9),
    ]


def test_matrix_configs_match_jax_recipe():
    entries = matrix.matrix_configs()
    recipe = _jax_matrix_recipe()
    assert len(entries) == len(recipe) == 5
    for entry, (jworld, jconfig, aspect) in zip(entries, recipe):
        assert dataclasses.asdict(entry.config) == dataclasses.asdict(jconfig)
        assert entry.aspect == aspect
        js = jworld.extract(with_bvh=False)
        ps = entry.world.extract(with_bvh=False, device="cpu")
        for table in ("spheres", "materials", "triangles"):
            jt, pt = getattr(js, table), getattr(ps, table)
            assert (jt is None) == (pt is None), table
            for name in (jt._fields if jt is not None else ()):
                np.testing.assert_array_equal(
                    getattr(pt, name).numpy(), np.asarray(getattr(jt, name)),
                    err_msg=f"{entry.name}: {table}.{name}")
        jcam = jworld.camera_state(aspect=aspect)
        assert camera_key(entry.world.camera_state(aspect=aspect,
                                                   device="cpu")) == tuple(
            float(np.float32(v)) for v in jax.tree.leaves(jcam))
    # Config 5 alone is hybrid: it composites over the raster cube that
    # both worlds hold.
    assert [e.config.level for e in entries] == [3, 3, 3, 3, 2]
    assert entries[4].world.n_raster == recipe[4][0].n_raster == 1
    assert [e.passes for e in entries] == [None, None, None, 16, None]


def test_matrix_configs_match_baseline_json():
    """Five entries, numbered as BASELINE.json's configs, at the sizes,
    samples and depth its text names."""
    texts = json.loads((ROOT / "BASELINE.json").read_text())["configs"]
    entries = matrix.matrix_configs()
    assert len(entries) == len(texts) == 5
    for i, (entry, text) in enumerate(zip(entries, texts)):
        assert entry.name.startswith(f"{i + 1}: ")
        cfg = entry.config
        size = re.search(r"(\d+)×(\d+)", text)
        if size:
            assert (cfg.width, cfg.height) == tuple(map(int, size.groups()))
        lines = re.search(r"(\d+)p\b", text)
        if lines:
            assert cfg.height == int(lines.group(1))
            assert cfg.width == cfg.height * 16 // 9
        spp = re.search(r"(\d+) spp", text)
        if spp:
            assert cfg.samples_per_pixel * (entry.passes or 1) == int(
                spp.group(1))
        depth = re.search(r"depth (\d+)", text)
        if depth:
            assert cfg.bounces == int(depth.group(1))
    assert "Defocus" in texts[3] and entries[3].config.defocus
    assert "emissive" in texts[3] and any(
        entries[3].world.extract(with_bvh=False, device="cpu")
        .materials.emissive_r.numpy() > 0)
    assert "Hybrid" in texts[4] and entries[4].config.level == 2
    assert "triangle" in texts[4] and entries[4].world.extract(
        with_bvh=False, device="cpu").triangles is not None


# -- each bench at a tiny size on the CPU ------------------------------------

def test_headline_tiny(recorded, capsys):
    row = headline.main(**TINY, bounces=4, n_frames=3, device="cpu")
    printed = capsys.readouterr().out
    want = _jax_keys("bench.py") - {"vs_family_ceiling_500"}
    assert want <= _printed_keys(printed)
    assert "vs_family_ceiling_500" not in _printed_keys(printed)
    assert json.loads(printed.strip().splitlines()[-1]) == row
    rays = _check_direct(recorded)
    scene = recorded[0][0][1]
    timed = [rays[id(scene), s][0] for s in (1, 2, 3)]
    assert row["timed_rays"] == timed
    assert row["rays_per_frame"] == int(np.mean(timed))
    assert row["device"] == "cpu" and row["n_spheres"] == 508
    assert row["launches"] == 0     # the plain version ran


def test_orbit_tiny(recorded, capsys):
    rows = orbit.bench(**TINY, frames=3, device="cpu")
    printed = capsys.readouterr().out
    assert (_jax_keys("scripts/bench_orbit.py") - {"device", "rows"}
            <= _printed_keys(printed))
    assert [r["config"].split()[0] for r in rows] == [
        "static", "orbit-synced", "orbit-pipelined", "edit-synced",
        "edit-pipelined"]
    for row in rows:
        piped = row["config"].split()[0].endswith("pipelined")
        assert ({"host_ms", "device_ms", "host_syncs"} <= set(row)) == piped
        if piped:
            assert row["host_ms"] > 0 and row["device_ms"] is None
            assert row["host_syncs"] == []
    _check_direct(recorded)


def test_edit_tiny(recorded, capsys):
    row = edit.bench_edit_loop(**TINY, frames=2, device="cpu")
    printed = capsys.readouterr().out
    assert (_jax_keys("scripts/bench_edit.py") - {"summary", "rows"}
            <= _printed_keys(printed))
    stages = row["stage_ms"]
    assert set(stages) == {"extract", "prepare", "prepare_kd_order",
                           "prepare_tables", "shortlists", "render"}
    assert all(v > 0 for v in stages.values())
    _check_direct(recorded)


def test_matrix_tiny(recorded, capsys):
    configs = [e._replace(config=dataclasses.replace(
        e.config, width=32, height=18, samples_per_pixel=1),
        passes=e.passes and 3) for e in matrix.matrix_configs()]
    rows = matrix.bench(configs, n=2, orbit_args=dict(**TINY, frames=2),
                        device="cpu")
    printed = capsys.readouterr().out
    assert (_jax_keys("scripts/bench_matrix.py") - {"device", "rows"}
            <= _printed_keys(printed))
    assert len(rows) == 5 + 5
    rays = _check_direct(recorded)
    scenes = iter(dict.fromkeys(id(call[1]) for call in recorded[0]))
    for entry, row in zip(configs, rows):
        if entry.passes is None:
            scene = next(scenes)
            want = [rays[scene, s][0] for s in (1, 2)]
            assert row["rays_per_frame"] == float(np.mean(want))
        else:
            # The passes after the first, as a fresh film counts them.
            prog = bt.ProgressiveRenderer(entry.config, backend="pallas",
                                          device="cpu")
            scene = entry.world.extract(with_bvh=False, device="cpu")
            cam = entry.world.camera_state(aspect=entry.aspect, device="cpu")
            counts = [int(prog.step(scene, cam, seed=s).rays_traced)
                      for s in range(entry.passes)]
            assert row["rays"] == counts[-1] - counts[0] > 0
            assert row["spp"] == entry.passes


def test_scaling_cpu_meshes(capsys, tmp_path):
    out = tmp_path / "scaling.json"
    assert scaling.main(n_max=4, out_path=str(out), device="cpu") == 0
    printed = capsys.readouterr().out
    # (The one key not printed names the environment of JAX's re-exec.)
    assert _jax_keys("scripts/scaling_bench.py") - {
        "_BEVYRAY_SCALING_CHILD"} <= (
        _printed_keys(printed) | set(json.loads(out.read_text())))
    records = json.loads(out.read_text())["records"]
    assert records[-1]["scaling_ok"] is True
    paths = [r for r in records if "path" in r]
    assert [(r["path"], r["devices"]) for r in paths] == [
        (p, n) for p in ("xla", "pallas") for n in (1, 2, 4)]
    for r in paths:
        assert r.get("matches_1dev", r.get("bitmatches_1dev")) is True
        assert r["rays"] == paths[0 if r["path"] == "xla" else 3]["rays"]
        if r["path"] == "pallas":
            assert sum(r["per_sp_shard_rays"]) == r["rays"]
            assert len(r["per_sp_shard_rays"]) == r["mesh"]["sp"]


def test_benches_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: headline.main(**TINY, n_frames=1),
                lambda: orbit.bench(**TINY, frames=2),
                lambda: edit.bench_edit_loop(**TINY, frames=1),
                lambda: scaling.main(n_max=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert resolve_device("cpu") == torch.device("cpu")


def test_bench_modules_import_no_jax():
    """Every module under bench/ imports with jax and the JAX package
    blocked, and none names them in an import."""
    names = sorted(p.stem for p in (ROOT / "bevyray_tpu_torch" / "bench")
                   .glob("*.py"))
    assert {"timing", "headline", "matrix", "orbit", "edit",
            "scaling"} <= set(names)
    for name in names:
        tree = ast.parse((ROOT / "bevyray_tpu_torch" / "bench"
                          / f"{name}.py").read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "bevyray_tpu")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'bevyray_tpu'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import bevyray_tpu_torch.bench.{n}\n" for n in names)
            + "assert not any(m == 'jax' or m.startswith('jax.') "
              "for m in sys.modules if sys.modules[m] is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# -- the host copies of the fused path ---------------------------------------

def test_host_camera_and_key_read_host_copies():
    cam = bt.rtiow.final_scene(seed=42).camera_state(aspect=16 / 9,
                                                     device="cpu")
    key = camera_key(cam)
    assert len(key) == 15 and key[9] == float(np.float32(np.pi / 4))
    assert camera_key(host_camera(cam)) == key
    # With a host copy on every leaf the key is read from them alone.
    for i, v in enumerate(camera_leaves(cam)):
        v.host_copy = np.float32(i)
    assert camera_key(cam) == tuple(float(i) for i in range(15))
    host = host_camera(cam)
    assert float(host.up.z) == 8.0 and float(host.focus_distance) == 14.0


def test_upload_and_host_array_on_the_cpu():
    a = np.arange(6, dtype=np.float32)
    t = upload(a, "cpu")
    assert t.device.type == "cpu" and np.shares_memory(t.numpy(), a)
    assert np.array_equal(host_array(t), a)
    t.host_copy = a + 1      # a tensor's host copy wins over its values
    assert np.array_equal(host_array(t), a + 1)


@pytest.mark.parametrize("world_fn", [
    lambda: bt.rtiow.final_scene(seed=42, grid=3),
    lambda: bt.rtiow.material_test_scene(),
    bt.World,
])
def test_prepared_sphere_table_built_on_the_host(world_fn):
    """The kernel's sphere table, built on the host from the host copies:
    rows cx, cy, cz, r² in the kd order, padding lanes a copy of sphere 0
    (r² -1e30 in an empty scene), as NumPy builds them from the extracted
    table; its host copy equal to it."""
    scene = world_fn().extract(with_bvh=False, device="cpu")
    kscene = mk.prepare_kernel_scene(scene)
    order = cached_order(scene, 0).numpy()
    sp = [leaf.numpy()[order] for leaf in scene.spheres]
    cx, cy, cz, radius, valid = sp[0], sp[1], sp[2], sp[3], sp[5]
    r = np.where(valid, np.abs(radius), np.float32(0))
    rows = [np.where(valid, c, c[0] if valid[0] else np.float32(0))
            for c in (cx, cy, cz)]
    pad = r[0] * r[0] if valid[0] else np.float32(-1e30)
    want = np.stack([*rows, np.where(valid, r * r, pad)]).astype(np.float32)
    np.testing.assert_array_equal(kscene.sph.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(host_array(kscene.sph), want)


@pytest.mark.cuda
def test_cuda_pipelined_host_work_waits_for_nothing():
    """On the card: a frame queued, then the next frame's host work (an
    edit, extract, kd order, tables, shortlists of a new camera) under
    torch's sync debug mode set to raise, and the host copies equal to the
    tensors they mirror."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    world = bt.rtiow.final_scene(seed=42)
    config = bt.RenderConfig(width=256, height=128, samples_per_pixel=4,
                             bounces=4, level=3)
    renderer = FusedRenderer(config)
    cams = orbit.orbit_cams(world, 3, 2.0, device=dev)
    apply_edit = orbit.edit_sequence(world, dev)
    scene = apply_edit(0)
    renderer.render(scene, cams[0], seed=1)
    torch.cuda.synchronize()
    renderer.render(scene, cams[0], seed=2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        nxt = apply_edit(1)
        kscene = renderer.prepare(nxt)
        renderer.shortlists(kscene, cams[1])
        cam = world.camera_state(aspect=2.0, device=dev)
        frame = renderer.render(nxt, cams[1], seed=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(frame.rays_traced) > 0
    for t in (*nxt.spheres, *nxt.materials, kscene.sph, *camera_leaves(cam)):
        np.testing.assert_array_equal(host_array(t), t.cpu().numpy())
