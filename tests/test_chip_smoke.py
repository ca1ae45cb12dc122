"""chip_smoke.py: refuses to run without a GPU, and its phases and oracle
comparisons hold on a tiny scene here (the full-size run is on the card)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from zig_vulkan_jax.engine.engine import VoxelRT
from zig_vulkan_jax.models.scenes import default_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = chip_smoke.Sizes(default=(64, 36), primary=(64, 36), shaded=(48, 27),
                        parity_side=12, edits=16, frames=2, fly_frames=3)


@pytest.fixture(scope="module")
def scene():
    # a 128x32x128-voxel corner of the default terrain; the default pose
    # at the origin looks across it
    return default_scene(dims=(32, 8, 32))


def _run(args, cwd, env, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run(["chip_smoke.py"], REPO, env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(["chip_smoke.py"], str(tmp_path), env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "No module named 'zig_vulkan_jax'" in r.stderr


def test_one_gpu_phases_pass_on_a_tiny_scene(scene, capsys):
    check = chip_smoke.Checks()
    chip_smoke.run_one_gpu(scene, jax.devices()[0], check, TINY)
    out = capsys.readouterr().out
    assert check.failed == []
    for phase in ("default workload", "denoise parity", "edit round 1",
                  "BENCHMARK REPORT", "skip path", "exact path",
                  "primary + sun shaded parity", "full shading parity",
                  "accumulated"):
        assert phase in out, phase


def test_primary_hit_parity_is_full_on_a_tiny_scene(scene):
    rt = VoxelRT(scene.grid, scene.materials,
                 chip_smoke.primary_config(96, 54))
    rt.render()
    ro, rd = chip_smoke.subsample_rays(rt.camera.d_camera, 16)
    for use_skip in (True, False):
        r = chip_smoke.primary_hit_parity(rt, scene, ro, rd, use_skip)
        assert r["hit_frac"] > 0.03, r
        assert r["found_agree"] == 1.0 and r["agree"] == 1.0, r
    assert chip_smoke.primary_pixel_parity(rt, scene, ro, rd) <= \
        chip_smoke.EXACT_PIXEL_ATOL


def test_shaded_and_denoise_parity_on_a_tiny_scene(scene):
    rt = VoxelRT(scene.grid, scene.materials,
                 chip_smoke.default_workload_config(48, 27, denoise=False))
    sh = chip_smoke.shaded_parity(rt, scene)
    assert sh["mean"] < chip_smoke.SHADED_MEAN_MAX, sh
    assert sh["off_frac"] < chip_smoke.SHADED_OFF_FRAC_MAX, sh
    assert sh["image_mean_diff"] < chip_smoke.SHADED_IMAGE_MEAN_MAX, sh
    img = np.asarray(rt.render())
    got, err = chip_smoke.denoise_parity(img, rt.denoiser)
    assert got.shape == img.shape
    assert err < chip_smoke.DENOISE_ATOL


def test_four_device_path_matches_one_device(scene):
    """The --four-gpus comparison, on four of the virtual CPU devices."""
    r = chip_smoke.sharded_vs_single(jax.devices()[:4], scene, 64, 32,
                                     frames=1)
    assert r["devices"] == 4 and r["shape"] == [32, 64, 3]
    assert r["off_frac"] < chip_smoke.SHARDED_OFF_FRAC_MAX, r


@pytest.mark.gpu
def test_chip_smoke_on_the_gpu(gpu):
    """The whole smoke run on the card: run with `python -m pytest tests
    -m gpu` on a machine with one GPU."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = _run(["chip_smoke.py"], REPO, env, timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
