"""amv_tpu_torch.parallel.sharding on a mesh of CPU devices against the
JAX package, and the kernels' launch guard.

The port's mesh is `make_mesh(["cpu"] * 8)`, the shape of JAX's virtual
8-device CPU mesh (`tests/test_sharding.py`).  Each `sharded_*` function
is held, bit for bit, to JAX's own sharded function where that is XLA
only (the video decode and encode steps, ADPCM decode and encode, the
G.729A decode scan at a small T), and to JAX's single-device XLA function
or host route where JAX shards a Pallas chain (its sharded versions take
~1,000 s in interpret mode, which is why `tests/test_sharding.py` is on
the slow list): the entropy decode, the G.729A encoder step, the
complete transcode (the host re-encode), the decode and encode chains and
the fused transcode step (JAX's two-stage transform, which its fused one
equals at 16-aligned sizes).  The sp carry of the DC prediction is
checked at MCU splits that cut a frame's DC chain mid-row.
Tolerance: equality.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from amv_tpu.bitstream.entropy import (huffman_decode_frames,  # noqa: E402
                                       huffman_encode_frame)
from amv_tpu.codecs import amv_video as JV  # noqa: E402
from amv_tpu.codecs import g729a as JG  # noqa: E402
from amv_tpu.kernels import adpcm as JA  # noqa: E402
from amv_tpu.parallel import sharding as JS  # noqa: E402
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.codecs import amv_video as PV  # noqa: E402
from amv_tpu_torch.codecs import g729a as G  # noqa: E402
from amv_tpu_torch.kernels import _build  # noqa: E402
from amv_tpu_torch.parallel import sharding as S  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the plain G.729A steps are many small ops, which
    intra-op threads slow down beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return S.make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    if jax.device_count() < 8:
        pytest.skip("needs JAX's 8 virtual CPU devices")
    return JS.make_mesh(jax.devices()[:8])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_mesh_shape(mesh, jmesh):
    assert mesh.devices.shape == (4, 2) == jmesh.devices.shape
    assert mesh.axis_names == ("dp", "sp") == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape) and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.flat)
    assert S.make_mesh(["cpu"] * 3).devices.shape == (3, 1)
    assert S.make_mesh(["cpu"] * 8, dp=2, sp=4).devices.shape == (2, 4)
    with pytest.raises(ValueError, match="needs 9 devices"):
        S.make_mesh(["cpu"] * 8, dp=3, sp=3)


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_mesh(["cuda:0"] * 2)


def test_sharded_video_roundtrip_matches_jax(mesh, jmesh):
    """tests/test_sharding.py's round trip (8 frames of 160x120, frames on
    dp and MCUs on sp: 40 MCUs a shard) against JAX's sharded steps."""
    rng = np.random.default_rng(3)
    lv = rng.integers(-32, 32, (8, 80, 6, 64)).astype(np.int16)
    jy, jcb, jcr = JS.sharded_decode_step(jmesh, 10, 8, 160, 120)(
        jnp.asarray(lv))
    y, cb, cr = S.sharded_decode_step(mesh, 10, 8, 160, 120)(_t(lv))
    for g, w in ((y, jy), (cb, jcb), (cr, jcr)):
        _eq(g, w)
    jlv = JS.sharded_encode_step(jmesh, 10, 8)(jy, jcb, jcr)
    _eq(S.sharded_encode_step(mesh, 10, 8)(y, cb, cr), jlv)


@pytest.mark.parametrize("dp,sp", [(4, 2), (2, 4), (1, 4)])
def test_sharded_decode_step_carries_dc_mid_row(dp, sp):
    """64x48 pictures (4 x 3 MCUs): sp = 2 cuts each frame after 6 MCUs
    (a row and a half), sp = 4 after 3 (three quarters of a row), so each
    shard's DC chains start from the carry of the shards before it; DC
    differences large enough that the running sums wrap int32."""
    mesh = S.make_mesh(["cpu"] * (dp * sp), dp=dp, sp=sp)
    rng = np.random.default_rng(dp * 10 + sp)
    f = 2 * dp
    lv = np.zeros((f, 12, 6, 64), np.int16)
    lv[..., 0] = rng.integers(-2047, 2048, lv.shape[:3])
    lv[..., 1:6] = rng.integers(-40, 41, lv[..., 1:6].shape)
    lv[0, :, :, 0] = 32767                  # the sums wrap
    want = JV.decode_transform(jnp.asarray(lv), 4, 3, 64, 48)
    got = S.sharded_decode_step(mesh, 4, 3, 64, 48)(_t(lv))
    one = PV.decode_transform(_t(lv), 4, 3, 64, 48)
    for g, w, o in zip(got, want, one):
        _eq(g, w)
        assert torch.equal(g, o)


def test_sharded_adpcm_decode_matches_jax(mesh, jmesh):
    rng = np.random.default_rng(4)
    pay = rng.integers(0, 256, (16, 64)).astype(np.uint8)
    pred = rng.integers(-1000, 1000, 16).astype(np.int32)
    sidx = rng.integers(0, 89, 16).astype(np.int32)
    want = JS.sharded_adpcm_decode(jmesh)(*map(jnp.asarray, (pay, pred,
                                                             sidx)))
    _eq(S.sharded_adpcm_decode(mesh)(_t(pay), _t(pred), _t(sidx)), want)


def test_sharded_adpcm_encode_matches_jax(mesh, jmesh):
    """JAX's nibbles and step indices before each sample against the
    port's nibble pairs and step indices before each even sample."""
    rng = np.random.default_rng(5)
    samples = rng.integers(-20000, 20000, (8, 128)).astype(np.int32)
    reset = np.zeros((8, 128), bool)
    reset[:, 0] = reset[3, 64] = True
    sidx0 = rng.integers(0, 89, 8).astype(np.int32)
    nib, sidx = JS.sharded_adpcm_encode(jmesh)(
        *map(jnp.asarray, (samples, reset, sidx0)))
    got, got_sidx = S.sharded_adpcm_encode(mesh)(
        _t(samples.astype(np.int16)), _t(reset), _t(sidx0))
    _eq(got, JA.nibbles_to_bytes(np.asarray(nib)))
    _eq(got_sidx, np.asarray(sidx)[:, 0::2])


def _g729_frames(t, b, seed):
    from test_g729 import make_frame
    rng = np.random.default_rng(seed)
    frames = np.zeros((t, b, 10), np.uint8)
    for i in range(t):
        for j in range(b):
            frames[i, j] = np.frombuffer(make_frame(rng), np.uint8)
    return frames


@pytest.mark.parametrize("name", ["sharded_g729_decode_scan",
                                  "sharded_g729_decode_chain"])
def test_sharded_g729_decode_matches_jax(mesh, jmesh, name):
    """Eight streams of 2 frames, a stream a shard, against JAX's sharded
    scan: the PCM and the state after the last frame."""
    frames = _g729_frames(2, 8, seed=6)
    parms = JG.unpack_frames(frames)
    jst, jpcm = JS.sharded_g729_decode_scan(jmesh)(JG.init_state(8),
                                                   jnp.asarray(parms))
    st, pcm = getattr(S, name)(mesh)(G.init_state(8, device="cpu"),
                                     _t(np.asarray(parms)))
    _eq(pcm, jpcm)
    for k, _ in G.STATE_FIELDS:
        _eq(st[k], jst[k])


def test_sharded_g729_encode_matches_jax(mesh):
    """One frame of eight streams through the encoder step (a stream a
    shard) against JAX's encode_frame_batch, and the scan's two frames
    against JAX's encode_frames_scan and the port's single-device scan."""
    from amv_tpu.codecs.g729a_encoder_tpu import (encode_frame_batch,
                                                  encode_frames_scan)
    from amv_tpu_torch.codecs import g729a_encoder_batch as E
    rng = np.random.default_rng(11)
    sig = np.round(3000 * rng.standard_normal((2, 8, 80))).astype(np.float32)
    jst, jhist, jparm = encode_frame_batch(JG.init_state(8),
                                           jnp.zeros((8, 160)),
                                           jnp.asarray(sig[0]))
    st0, h0 = G.init_state(8, device="cpu"), torch.zeros((8, 160))
    st, hist, parm = S.sharded_g729_encode_step(mesh)(st0, h0, _t(sig[0]))
    _eq(parm, jparm)
    _eq(hist, jhist)
    _eq(st["exc"], jst["exc"])
    got = S.sharded_g729_encode_scan(mesh)(st0, h0, _t(sig))
    jst, jhist, jparms = encode_frames_scan(JG.init_state(8),
                                            jnp.zeros((8, 160)),
                                            jnp.asarray(sig))
    _eq(got[2], jparms)
    _eq(got[1], jhist)
    for k, _ in G.STATE_FIELDS:
        _eq(got[0][k], jst[k])
    want = E.encode_frames_scan(st0, h0, _t(sig))
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(got[0][k], want[0][k]), k


def _scans(f, m, seed):
    """tests/test_sharding.py's payloads: levels with a DC and a first AC
    a block, Huffman-coded by the JAX package; their unescaped rows."""
    rng = np.random.default_rng(seed)
    lv = np.zeros((f, m, 6, 64), np.int16)
    lv[..., 0] = rng.integers(-8, 48, (f, m, 6))
    lv[..., 1] = rng.integers(-4, 4, (f, m, 6))
    lv[..., 5] = rng.integers(-3, 3, (f, m, 6))
    pays = [huffman_encode_frame(lv[i]) for i in range(f)]
    rows, lens = native.unescape_frames(pays)
    return pays, _t(rows), _t(lens)


def _reencode(pays, m, mb_w, mb_h):
    """The JAX package's host re-encode at qscale 2, its fused transform
    as JAX's two-stage one (equal at 16-aligned sizes)."""
    w, h = 16 * mb_w, 16 * mb_h
    lv = jnp.asarray(huffman_decode_frames(pays, m))
    lv2 = np.asarray(JV.encode_transform(
        *JV.decode_transform(lv, mb_w, mb_h, w, h), mb_w, mb_h, 2))
    return [huffman_encode_frame(lv2[i]) for i in range(len(pays))]


def test_sharded_entropy_decode_matches_jax(mesh):
    from amv_tpu.kernels.entropy_decode import decode_scans_device
    pays, rows, lens = _scans(16, 2, seed=12)
    lv, ok = S.sharded_entropy_decode(mesh, 2)(rows, lens)
    assert bool(ok.all())
    _eq(lv, decode_scans_device(jnp.asarray(rows.numpy()), 2))
    _eq(lv, huffman_decode_frames(pays, 2))


@pytest.mark.parametrize("enc", ["async", "record"])
def test_sharded_complete_transcode_matches_host(mesh, enc):
    """The complete chain with frames over the whole mesh: the escaped
    words equal the JAX host re-encode, and words, bits and ok equal one
    single-device call (words padded to the longest frame of all)."""
    pays, rows, lens = _scans(16, 2, seed=11)
    words, bits, ok = S.sharded_complete_transcode(mesh, 2, 2, enc=enc)(
        rows, lens)
    w1, b1, ok1 = P.transcode_complete(rows, lens, 2, 2, enc=enc)
    assert torch.equal(words, w1) and torch.equal(bits, b1)
    assert torch.equal(ok, ok1) and bool(ok.all())
    assert native.escape_frames(words.numpy(), bits.numpy()) == \
        _reencode(pays, 2, 2, 1)
    w2, b2, ok_shards = S.sharded_complete_transcode_async(mesh, 2, 2)(
        rows, lens)
    assert torch.equal(w2, w1) and torch.equal(b2, b1)
    assert ok_shards.dtype == torch.int32 and ok_shards.tolist() == [1] * 8


def test_sharded_complete_transcode_ok_names_the_shard(mesh):
    """A frame the decoder rejects clears its shard's entry only."""
    pays, rows, lens = _scans(16, 2, seed=13)
    rows[9, :] = 0xFF
    _, _, ok = S.sharded_complete_transcode_async(mesh, 2, 2)(rows, lens)
    assert ok.tolist() == [1, 1, 1, 1, 0, 1, 1, 1]


def test_sharded_decode_scans_matches_jax(mesh):
    """D, the DC prediction and U over the mesh: the JAX decode of the
    host-decoded levels."""
    pays, rows, lens = _scans(16, 2, seed=14)
    y, cb, cr, ok = S.sharded_decode_scans(mesh, 32, 16)(rows, lens)
    assert bool(ok.all())
    want = JV.decode_transform(jnp.asarray(huffman_decode_frames(pays, 2)),
                               2, 1, 32, 16)
    for g, w in zip((y, cb, cr), want):
        _eq(g, w)


def test_sharded_encode_planes_matches_jax(mesh):
    """V then E over the mesh: the escaped words equal the JAX package's
    encode_transform Huffman-coded on the host."""
    rng = np.random.default_rng(15)
    y = rng.integers(0, 256, (16, 32, 48), np.uint8)
    cb = rng.integers(0, 256, (16, 16, 24), np.uint8)
    cr = rng.integers(0, 256, (16, 16, 24), np.uint8)
    words, bits = S.sharded_encode_planes(mesh, 3, 2)(_t(y), _t(cb), _t(cr))
    lv = np.asarray(JV.encode_transform(*map(jnp.asarray, (y, cb, cr)),
                                        3, 2, 2))
    assert native.escape_frames(words.numpy(), bits.numpy()) == \
        [huffman_encode_frame(lv[i]) for i in range(16)]
    assert PV.encode_frames(y, cb, cr, device="cpu") == \
        native.escape_frames(words.numpy(), bits.numpy())


def test_sharded_transcode_step_matches_jax(mesh):
    """The fused transcode (kernel T's pixel entry) over the mesh: the
    levels equal JAX's two-stage transform at 48x32, the pixels one
    single-device call's."""
    rng = np.random.default_rng(16)
    lv = np.zeros((8, 6, 6, 64), np.int16)
    lv[..., 0] = rng.integers(-60, 60, lv.shape[:3])
    lv[..., 1:10] = rng.integers(-30, 31, lv[..., 1:10].shape)
    lv2, pix = S.sharded_transcode_step(mesh)(_t(lv))
    want = JV.encode_transform(*JV.decode_transform(jnp.asarray(lv), 3, 2,
                                                    48, 32), 3, 2, 2)
    _eq(lv2, want)
    one = P.transcode_levels_fused(_t(lv))
    assert torch.equal(lv2, one[0]) and torch.equal(pix, one[1])


@pytest.mark.parametrize("name,args", [
    ("sharded_adpcm_decode", (np.zeros((12, 4), np.uint8),
                              np.zeros(12, np.int32),
                              np.zeros(12, np.int32))),
    ("sharded_entropy_decode", (np.zeros((12, 8), np.uint8),
                                np.zeros(12, np.int64)))])
def test_non_dividing_batch_raises(mesh, name, args):
    fn = getattr(S, name)(mesh, *((2,) if "entropy" in name else ()))
    with pytest.raises(ValueError, match=r"mesh\.size=8"):
        fn(*map(_t, args))
    with pytest.raises(ValueError, match=r"mesh\.size=8"):
        S.sharded_decode_step(mesh, 10, 8, 160, 120)(
            torch.zeros((6, 80, 6, 64), dtype=torch.int16))


# ------------------------------------------------------------ launch guard

def _port_sources():
    for d, _, files in os.walk(os.path.join(ROOT, "amv_tpu_torch")):
        yield from (os.path.join(d, f) for f in sorted(files)
                    if f.endswith(".py"))
    yield os.path.join(ROOT, "chip_smoke.py")


def _guarded(node, parents) -> bool:
    """node lies inside a `with ..._build.on_device(...)` (or `with
    on_device(...)`) block."""
    p = parents.get(node)
    while p is not None:
        if isinstance(p, ast.With) and any(
                isinstance(i.context_expr, ast.Call) and
                getattr(i.context_expr.func, "attr",
                        getattr(i.context_expr.func, "id", None)) ==
                "on_device" for i in p.items):
            return True
        p = parents.get(p)
    return False


def test_every_kernel_launch_goes_through_the_guard():
    """Every use of a C entry of the kernel library (a name in
    `_build._SIGNATURES`, other than setting its argtypes or restype) in
    the port's sources and chip_smoke.py lies inside `_build.on_device`,
    which makes the tensors' card current and takes its stream; no source
    but _build.py takes a stream by itself, and `_build.library()` is
    called elsewhere only as a statement (a build that launches
    nothing)."""
    entries = set(_build._SIGNATURES)
    bad, checked = [], 0
    for f in _port_sources():
        if f.endswith(os.path.join("kernels", "_build.py")):
            continue
        tree = ast.parse(open(f).read())
        parents = {c: p for p in ast.walk(tree)
                   for c in ast.iter_child_nodes(p)}
        for node in ast.walk(tree):
            where = f"{os.path.relpath(f, ROOT)}:{getattr(node, 'lineno', 0)}"
            if isinstance(node, ast.Attribute) and node.attr in entries:
                up = parents.get(node)
                if isinstance(up, ast.Attribute) and up.attr in (
                        "argtypes", "restype"):
                    continue
                checked += 1
                if not _guarded(node, parents):
                    bad.append(f"{where} {node.attr} outside on_device")
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "_build":
                if node.attr == "stream":
                    bad.append(f"{where} _build.stream")
                if node.attr == "library" and not isinstance(
                        parents.get(parents.get(node)), ast.Expr):
                    bad.append(f"{where} _build.library() used")
            if isinstance(node, ast.Attribute) and node.attr == \
                    "current_stream" and "cuda_stream" in ast.unparse(
                        parents.get(node, node)):
                bad.append(f"{where} a raw stream outside the guard")
    assert not bad, bad
    assert checked >= 25


def test_guard_takes_the_tensors_device():
    """on_device refuses CPU tensors and tensors of two devices; device_key
    names the current card's index for "cuda"."""
    with pytest.raises(ValueError, match="one CUDA device"):
        with _build.on_device(torch.zeros(1)):
            pass
    assert _build.device_key("cpu") == torch.device("cpu")
    assert _build.device_key(torch.device("cuda", 1)) == \
        torch.device("cuda", 1)
