"""utils.jitcache: one fixed cache directory per checkout, or the one
JAX_COMPILATION_CACHE_DIR names."""

import os
import subprocess
import sys

from zig_vulkan_jax.utils import jitcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env):
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip()


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def test_checkout_dir_is_fixed_and_ignored(tmp_path):
    code = "from zig_vulkan_jax.utils import jitcache; print(jitcache.cache_dir())"
    first = _python(code, _env())
    # a second process, started from elsewhere, finds the same directory
    second = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path),
        env=_env(PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300).stdout.strip()
    assert first == second == jitcache.CHECKOUT_CACHE_DIR
    assert os.path.dirname(first) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert os.path.basename(first) + "/" in f.read().split()


def test_env_dir_takes_every_entry(tmp_path):
    cache = tmp_path / "cache"
    before = (set(os.listdir(jitcache.CHECKOUT_CACHE_DIR))
              if os.path.isdir(jitcache.CHECKOUT_CACHE_DIR) else set())
    out = _python(
        "import jax, jax.numpy as jnp\n"
        "from zig_vulkan_jax.utils import jitcache\n"
        "d = jitcache.enable(min_compile_time_secs=0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()\n"
        "print(d)\n",
        _env(JAX_COMPILATION_CACHE_DIR=str(cache)))
    assert out == str(cache)
    assert len(os.listdir(cache)) > 0
    after = (set(os.listdir(jitcache.CHECKOUT_CACHE_DIR))
             if os.path.isdir(jitcache.CHECKOUT_CACHE_DIR) else set())
    assert after == before
