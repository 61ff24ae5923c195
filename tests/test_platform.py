"""Platform plumbing: the pytree struct helper, the stdlib PNG writer, the
compile-cache location, the GPU-only guard of chip_smoke.py, and a render
that needs neither flax nor PIL."""
import dataclasses
import os
import struct as pystruct
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lumenrenderer_tpu.render import tonemap
from lumenrenderer_tpu.utils import compile_cache, struct

ROOT = Path(__file__).resolve().parents[1]


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = struct.field(static=True, default=3)


def test_struct_flattens_data_fields_only():
    p = _Pair(a=jnp.ones(2), b=jnp.zeros(3), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    q = jax.tree_util.tree_unflatten(treedef, [x + 1 for x in leaves])
    assert q.n == 5
    np.testing.assert_array_equal(q.b, np.ones(3))


def test_struct_static_field_is_part_of_the_treedef():
    p5 = _Pair(a=jnp.ones(2), b=jnp.ones(2), n=5)
    p6 = _Pair(a=jnp.ones(2), b=jnp.ones(2), n=6)
    assert (jax.tree_util.tree_structure(p5)
            != jax.tree_util.tree_structure(p6))
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)
        return p.a * p.n

    np.testing.assert_array_equal(f(p5), 5.0)
    np.testing.assert_array_equal(f(p6), 6.0)
    assert traces == [5, 6]


def test_struct_replace_and_frozen():
    p = _Pair(a=jnp.ones(2), b=jnp.zeros(2))
    q = p.replace(b=jnp.full(2, 7.0))
    np.testing.assert_array_equal(q.b, 7.0)
    np.testing.assert_array_equal(p.b, 0.0)
    assert q.n == 3
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(2)


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = pystruct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = pystruct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + length
    w, h, depth, color, _, _, _ = pystruct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()  # filter type None
    return rows[:, 1:].reshape(h, w, 3)


def test_png_writer_round_trip(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (13, 7, 3), np.uint8)
    path = tmp_path / "x.png"
    tonemap.save_png(str(path), img)
    np.testing.assert_array_equal(_decode_png(path.read_bytes()), img)


def test_compile_cache_dir_rule():
    env = compile_cache.ENV
    assert compile_cache.cache_dir({env: "/elsewhere/cache"}) == \
        "/elsewhere/cache"
    assert compile_cache.cache_dir({}) == str(ROOT / ".jax_cache")


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_enable(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    else:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
    try:
        got = compile_cache.enable()
        if env_set:
            assert got == str(tmp_path)
            # JAX reads the variable itself; nothing is set in code
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert got == str(ROOT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_the_cpu(monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "build_native", lambda: None)
    before = jax.config.jax_compilation_cache_dir
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
    assert jax.config.jax_compilation_cache_dir == before


_NO_FLAX_PIL = """
import sys
sys.modules["flax"] = None
sys.modules["PIL"] = None
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from lumenrenderer_tpu.integrator.wavefront import RenderConfig
from lumenrenderer_tpu.render.renderer import Renderer
from lumenrenderer_tpu.scene import presets
builder, camf = presets.cornell_box()
cfg = RenderConfig(width=64, height=64, max_depth=2, bsdf="lambert")
r = Renderer(builder.build(), cfg, accel="tiled", cluster_size=32,
             interpret=True)
img = r.render_png(camf(1.0), sys.argv[1], spp=1)
assert np.isfinite(img).all() and img.mean() > 0
assert "flax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
"""


def test_render_without_flax_or_pil(tmp_path):
    out = tmp_path / "frame.png"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", _NO_FLAX_PIL, str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _decode_png(out.read_bytes()).shape == (64, 64, 3)
