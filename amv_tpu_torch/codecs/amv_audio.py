"""AMV IMA-ADPCM audio codec on the device: decode and encode.

The counterpart of `amv_tpu/codecs/amv_audio.py`.  Chunk framing follows
AMVmuxer/ffmpeg/libavcodec/adpcm.c:

* decode: each '01wb' payload = {le16 predictor, le16 step_index, le32
  sample_count} + packed nibbles, high nibble first (adpcm.c:1268-1290);
  all chunks decode in one launch of kernel A;
* encode: chunk scheduling with odd-frame carry and second-boundary
  padding (adpcm.c:461-496), step_index carried across chunks,
  prev_sample reset to each chunk's first input sample; the whole stream
  is one launch of kernel Q.  trellis=True (the reference's `-trellis`,
  `amv_tpu/codecs/amv_audio.py:_encode_stream_trellis`) runs the Viterbi
  quantizer of kernel L over the chunks, its chain started from kernel Q's
  step indices at the chunk starts (`kernels.adpcm_trellis.encode_chain`).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..kernels.adpcm import decode_chunks as _decode
from ..kernels.adpcm import encode_streams
from ..kernels.adpcm_trellis import encode_chain
from ..verify.ref_adpcm import chunk_lengths


def chunk_arrays(chunks: list[bytes]):
    """'01wb' payloads -> kernel A's inputs as numpy arrays: (payload
    uint8 [C, max bytes] zero-padded, pred int32 [C], sidx int32 [C]
    clamped to 0..88, nibble bytes int64 [C])."""
    n = len(chunks)
    lens = np.array([max(len(c) - 8, 0) for c in chunks], dtype=np.int64)
    payload = np.zeros((n, max(int(lens.max()), 1)), dtype=np.uint8)
    pred = np.zeros(n, dtype=np.int32)
    sidx = np.zeros(n, dtype=np.int32)
    for i, c in enumerate(chunks):
        if len(c) < 8:
            continue
        pred[i] = struct.unpack_from("<h", c, 0)[0]
        sidx[i] = min(max(struct.unpack_from("<H", c, 2)[0], 0), 88)
        payload[i, :lens[i]] = np.frombuffer(c, dtype=np.uint8)[8:]
    return payload, pred, sidx, lens


def decode_chunks(chunks: list[bytes], *, device) -> np.ndarray:
    """Decode '01wb' payloads to one contiguous int16 PCM stream on
    `device`.  Like the reference decoder, every nibble byte present is
    decoded; the header's sample count is ignored (adpcm.c:1272-1274)."""
    if not chunks:
        return np.zeros(0, dtype=np.int16)
    payload, pred, sidx, lens = chunk_arrays(chunks)
    dev = torch.device(device)
    pcm = _decode(*(torch.from_numpy(a).to(dev)
                    for a in (payload, pred, sidx))).cpu().numpy()
    return np.concatenate([pcm[i, :2 * lens[i]] for i in range(len(lens))])


def stream_layout(samples: np.ndarray, frame_size: int, sample_rate: int):
    """The encoder's chunk schedule over an int16 stream: (ns, the sample
    pairs of each chunk; starts int64 [C], each chunk's first sample;
    padded int16 [2 * sum(ns)], the stream zero-padded to whole chunks;
    reset bool [2 * sum(ns)], True at each chunk's first sample)."""
    ns = chunk_lengths(len(samples), frame_size, sample_rate)
    total = 2 * sum(ns)
    padded = np.zeros(total, dtype=np.int16)
    padded[:len(samples)] = samples
    starts = np.zeros(len(ns), dtype=np.int64)
    np.cumsum(np.asarray(ns[:-1], np.int64) * 2, out=starts[1:])
    reset = np.zeros(total, dtype=bool)
    reset[starts] = True
    return ns, starts, padded, reset


def encode_stream(samples: np.ndarray, frame_size: int,
                  sample_rate: int = 22050, init_step_index: int = 0,
                  trellis: bool = False, *, device) -> list[bytes]:
    """Encode an int16 PCM stream into AMV '01wb' chunk payloads on
    `device`; byte-identical to `amv_tpu.verify.ref_adpcm.encode`, or with
    trellis=True (the Viterbi quantizer, kernel L) to the JAX package's
    `encode_stream(trellis=True)`."""
    ns, starts, padded, reset = stream_layout(
        np.asarray(samples, dtype=np.int16), frame_size, sample_rate)
    if not ns:
        return []
    dev = torch.device(device)
    x = torch.from_numpy(padded).to(dev)
    packed, sidx_even = encode_streams(
        x[None], torch.from_numpy(reset[None]).to(dev),
        torch.tensor([init_step_index], dtype=torch.int32, device=dev))
    starts_d = torch.from_numpy(starts).to(dev)
    sidx_at = sidx_even[0, starts_d // 2]
    if trellis:
        # Q's step indices at the chunk starts are the chain's round-1
        # guesses
        packed, sidx_at, _ = encode_chain(
            x, starts_d, torch.tensor(ns, dtype=torch.int32, device=dev),
            init_step_index, sidx_at.to(torch.int32))
    else:
        packed = packed[0]
    packed, sidx_at = packed.cpu().numpy(), sidx_at.cpu().numpy()
    chunks = []
    for k, n in enumerate(ns):
        s = int(starts[k])
        header = struct.pack("<hHI", int(padded[s]), int(sidx_at[k]),
                             (n << 1) & 0xFFFFFFFF)
        chunks.append(header + packed[s // 2: s // 2 + n].tobytes())
    return chunks
