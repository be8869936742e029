"""A run driven on the CPU (the harness's look for a card skipped) with
the timed path broken underneath: `correct` has to come out false, once
for each fault a cell can have; and unbroken, true."""

import pytest
import torch

from portbench import run as R

# each cell at a size the CPU's plain versions run in seconds
TINY = {
    "amv.films": {"films": 2, "frames_min": 40, "frames_max": 72,
                  "pictures": 32, "audio_chunks": 8},
    "act.library_decode": {"streams": 3, "frames": 12, "check_streams": 2},
    "act.one_file": {"recordings": 3, "seconds_min": 0.1,
                     "seconds_max": 0.3, "extra_checks": 2},
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _amv_altered(out):
    b = bytearray(out)
    b[len(b) // 2] ^= 0x01
    return bytes(b)


def _amv_half(out):
    from amv_tpu_torch.containers import riff
    s = riff.demux(out)
    n = len(s.video_chunks)
    return riff.mux(s.video_chunks[:n // 2], s.audio_chunks[:n // 2],
                    width=s.info.width, height=s.info.height,
                    fps=s.info.fps_num, sample_rate=s.info.sample_rate)


def _pcm_altered(pcm):
    pcm = pcm.clone()
    pcm[0, pcm.shape[1] // 2] += 1
    return pcm


def _pcm_half(pcm):
    pcm = pcm.clone()
    pcm[pcm.shape[0] // 2:] = 0        # half the streams never decoded
    return pcm


def _wav_altered(path):
    with open(path, "r+b") as f:
        f.seek(44 + 2 * 200)
        b = f.read(1)
        f.seek(44 + 2 * 200)
        f.write(bytes([b[0] ^ 1]))


def _wav_half(path):
    with open(path, "rb") as f:
        data = f.read()
    n = (len(data) - 44) // 2 // 2 * 2
    body = data[44:44 + n] + bytes(len(data) - 44 - n)   # half left silent
    with open(path, "wb") as f:
        f.write(data[:44] + body)


def _wrap_entry(d, fault):
    orig = d.entry
    d.entry = lambda data, **k: fault(orig(data, **k))


def _wrap_decode(d, fault):
    orig = d.decode
    d.decode = lambda frames: fault(orig(frames))


def _wrap_main(d, fault):
    orig = d.main

    def main(argv):
        rc = orig(argv)
        fault(argv[-1])
        return rc
    d.main = main


FAULTS = {
    ("amv.films", "answer_altered"): (_wrap_entry, _amv_altered),
    ("amv.films", "half_left_out"): (_wrap_entry, _amv_half),
    ("act.library_decode", "answer_altered"): (_wrap_decode, _pcm_altered),
    ("act.library_decode", "half_left_out"): (_wrap_decode, _pcm_half),
    ("act.one_file", "answer_altered"): (_wrap_main, _wav_altered),
    ("act.one_file", "half_left_out"): (_wrap_main, _wav_half),
}


def tiny_spec(cell):
    spec = R.cell_spec(cell)
    spec["traffic"]["params"].update(TINY[cell])
    return spec


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    wrap, how = FAULTS[(cell, fault)]
    make = R.make_driver

    def broken(spec, seed, spans, device="cuda"):
        d = make(spec, seed, spans, device)
        setup = d.setup

        def broken_setup():
            setup()
            wrap(d, how)
        d.setup = broken_setup
        return d

    monkeypatch.setattr(R, "make_driver", broken)
    out = R.run(tiny_spec(cell), 2**31 + 99, 0.1, False, device="cpu")
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_an_unbroken_run_is_correct(cell):
    out = R.run(tiny_spec(cell), 2**32 + 5, 0.1, False, device="cpu")
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in
                                   R.cell_spec(cell)["end_to_end"]}
    assert all(v["value"] > 0 for v in out["metrics"].values())
