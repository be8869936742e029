"""WAV/AVI audio ingest on a device: PCM variants, G.711, IMA and MS ADPCM.

The port of `amv_tpu/codecs/wav_audio.py`:

* PCM u8/s16/s24/s32 -> s16 (pcm.c:380-470: keep the top 16 bits);
* A-law / mu-law (pcm.c:45-75 G.711 expansion, a table lookup);
* IMA-ADPCM-WAV, wFormatTag 0x11 (adpcm.c:983-1014), through kernel A;
* MS-ADPCM, wFormatTag 0x02 (adpcm.c:1041-1106), through
  `kernels.adpcm.decode_ms_nibbles`.

The bytes go to the device once; the PCM formats convert there.  Both
ADPCM flavours reset their state in every block header, so a stream
decodes as one batch of (block x channel) lanes; the host only splits the
headers and lays the nibbles out.  Every function returns an int16
tensor on `device`, [n] for one channel, [n, channels] for more, equal to
the JAX package's array.  Oracles: `verify/ref_wav_audio.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import adpcm as K
from ..pipeline import resolve_device, upload
from ..verify.ref_wav_audio import (ALAW_TABLE, MS_ADAPT_COEFF1,
                                    MS_ADAPT_COEFF2, ULAW_TABLE)

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_ADPCM_MS = 0x0002
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_ADPCM_IMA = 0x0011

# each byte with its nibbles swapped: IMA-WAV stores the low nibble first,
# kernel A decodes the high one first
_SWAP = ((np.arange(256) & 15) << 4 | np.arange(256) >> 4).astype(np.uint8)


def _deinterleave(samples: torch.Tensor, channels: int) -> torch.Tensor:
    out = samples[:samples.shape[0] // channels * channels]
    return out.reshape(-1, channels) if channels > 1 else out


def _empty(channels: int, dev) -> torch.Tensor:
    return torch.zeros((0, channels) if channels > 1 else 0,
                       dtype=torch.int16, device=dev)


def downmix(pcm: torch.Tensor) -> torch.Tensor:
    """int16 [n, ch] -> int16 [n]: the channels' mean truncated toward
    zero, as the JAX package's `pcm.mean(axis=1).astype(np.int16)`."""
    s = pcm.to(torch.int32).sum(dim=1)
    return torch.div(s, pcm.shape[1], rounding_mode="trunc").to(torch.int16)


def decode_pcm_bytes(data: bytes, fmt: int, bits: int, channels: int,
                     block_align: int = 0, *, device) -> torch.Tensor:
    """Decode an audio byte stream to int16 PCM [n] (mono) or [n, ch] on
    `device`."""
    dev = resolve_device(device)
    if fmt == WAVE_FORMAT_ADPCM_IMA:
        return decode_ima_wav(data, channels, block_align, device=dev)
    if fmt == WAVE_FORMAT_ADPCM_MS:
        return decode_ms(data, channels, block_align, device=dev)
    if fmt == WAVE_FORMAT_PCM and bits not in (8, 16, 24, 32):
        raise ValueError(f"unsupported PCM bit depth {bits}")
    if fmt not in (WAVE_FORMAT_PCM, WAVE_FORMAT_ALAW, WAVE_FORMAT_MULAW):
        raise ValueError(f"unsupported WAVE format tag 0x{fmt:04x}")
    raw = upload(np.frombuffer(data, np.uint8), dev)
    if fmt == WAVE_FORMAT_ALAW or fmt == WAVE_FORMAT_MULAW:
        table = ALAW_TABLE if fmt == WAVE_FORMAT_ALAW else ULAW_TABLE
        s = upload(table, dev)[raw.long()]
    elif bits == 8:
        s = (raw.to(torch.int16) - 128) << 8
    else:
        # decode_to16: the top 16 bits of each sample (pcm.c:340-378)
        w = bits // 8
        n = raw.shape[0] // w
        s = raw[:n * w].view(n, w)[:, w - 2:].contiguous().view(torch.int16)
        s = s.reshape(-1)
    return _deinterleave(s, channels)


def _split_blocks(data: bytes, block_align: int, min_len: int):
    """(full: uint8 [B, block_align] of the whole blocks, last: uint8 [1,
    k] of a shorter last block or None); a block under min_len bytes is
    dropped."""
    if block_align <= 0:
        block_align = len(data)
    if block_align == 0:
        raise ValueError("no audio data and no block_align")
    buf = np.frombuffer(data, np.uint8)
    nf = len(buf) // block_align
    full = buf[:nf * block_align].reshape(nf, block_align)
    if block_align < min_len:
        full = full[:0]
    tail = buf[nf * block_align:]
    return full, (tail[None] if len(tail) >= min_len else None)


def _le16(b: np.ndarray) -> np.ndarray:
    """int16 of little-endian byte pairs [..., 2]."""
    return (b[..., 0].astype(np.uint16) |
            b[..., 1].astype(np.uint16) << 8).view(np.int16)


def _ima_lanes(blocks: np.ndarray, ch: int):
    """IMA-WAV blocks uint8 [B, k] -> kernel A's lanes, block-major:
    (bytes uint8 [B * ch, m] nibble-swapped, pred int32 [B * ch], sidx
    int32 [B * ch]); a lane's m bytes are its channel's 4-byte groups in
    order (all of the body for one channel)."""
    nb = blocks.shape[0]
    hdr = blocks[:, :4 * ch].reshape(nb, ch, 4)
    body = blocks[:, 4 * ch:]
    if ch > 1:
        ng = body.shape[1] // (4 * ch)
        body = body[:, :ng * 4 * ch].reshape(nb, ng, ch, 4).transpose(
            0, 2, 1, 3)
    return (_SWAP[body.reshape(nb * ch, -1)],
            _le16(hdr[..., :2]).reshape(-1).astype(np.int32),
            np.minimum(hdr[..., 2], 88).reshape(-1).astype(np.int32))


def _ms_lanes(blocks: np.ndarray, ch: int):
    """MS-ADPCM blocks uint8 [B, k] -> (nibbles uint8 [B * ch, n] in emit
    order, coeff1, coeff2, idelta, sample1, sample2 int32 [B * ch]).  One
    channel takes the high then the low nibble of each byte; with more,
    channel 0 takes the high nibbles and channel 1 the low ones, and the
    lanes of channels 2 and up decode zero nibbles (as in the JAX
    package)."""
    nb = blocks.shape[0]
    pr = np.minimum(blocks[:, :ch], 6).reshape(-1)
    st = _le16(blocks[:, ch:7 * ch].reshape(nb, 3, ch, 2)).astype(np.int32)
    body = blocks[:, 7 * ch:]
    if ch == 1:
        nib = np.stack([body >> 4, body & 15], -1).reshape(nb, -1)
    else:
        nib = np.zeros((nb, ch, body.shape[1]), np.uint8)
        nib[:, 0], nib[:, 1] = body >> 4, body & 15
    return (nib.reshape(nb * ch, -1),
            np.asarray(MS_ADAPT_COEFF1, np.int32)[pr],
            np.asarray(MS_ADAPT_COEFF2, np.int32)[pr],
            *(st[:, k].reshape(-1) for k in range(3)))


def _pad_cat(parts):
    """Row-concatenate 2-D arrays, zero-padding each to the widest."""
    n = max(p.shape[1] for p in parts)
    return np.concatenate([np.pad(p, ((0, 0), (0, n - p.shape[1])))
                           for p in parts])


def _lanes(data, channels, block_align, min_len, lanes):
    """Split into blocks and lay out each group of equal blocks' lanes:
    ([(blocks, lane width)], the lanes' arrays padded and concatenated),
    or None when no block is long enough."""
    full, last = _split_blocks(data, block_align, min_len)
    groups = [g for g in (full, last) if g is not None and len(g)]
    if not groups:
        return None
    parts = [lanes(g, channels) for g in groups]
    sizes = [(len(g), p[0].shape[1]) for g, p in zip(groups, parts)]
    return sizes, [_pad_cat([p[0] for p in parts])] + [
        np.concatenate([p[k] for p in parts]) for k in range(1, len(parts[0]))]


def _unlane(dec: torch.Tensor, sizes, ch: int, per: int, head=None):
    """Decoded lanes [L, n] -> int16 [samples, ch], block by block: each
    group's lanes cropped to `per` x its lane width, channels interleaved,
    after the group's `head` rows [B, r, ch] where given."""
    out, row = [], 0
    for k, (nb, width) in enumerate(sizes):
        blk = dec[row:row + nb * ch, :per * width].reshape(nb, ch, -1)
        blk = blk.transpose(1, 2)
        if head is not None:
            blk = torch.cat([head[k], blk], dim=1)
        out.append(blk.reshape(-1, ch))
        row += nb * ch
    return torch.cat(out)


def decode_ima_wav(data: bytes, channels: int, block_align: int, *,
                   device) -> torch.Tensor:
    """IMA-ADPCM-WAV (adpcm.c:983-1014): 4-byte channel headers, 4-byte
    channel-interleaved nibble groups, the low nibble first, expand
    shift=3.  The same expand as AMV's, so kernel A decodes every (block,
    channel) lane in one launch: the host swaps each byte's nibbles and
    de-interleaves the channels' groups; the rows are zero-padded to the
    longest and each is cropped to its length after."""
    dev = resolve_device(device)
    lanes = _lanes(data, channels, block_align, 4 * channels, _ima_lanes)
    if lanes is None:
        return _empty(channels, dev)
    sizes, (payload, pred, sidx) = lanes
    if payload.shape[1] == 0:
        return _empty(channels, dev)
    dec = K.decode_chunks(*(upload(a, dev) for a in (payload, pred, sidx)))
    pcm = _unlane(dec, sizes, channels, 2)
    return pcm if channels > 1 else pcm[:, 0]


def decode_ms(data: bytes, channels: int, block_align: int, *,
              device) -> torch.Tensor:
    """MS-ADPCM (adpcm.c:1041-1106): 7-byte channel headers; emits sample1
    then sample2 (this fork's order), then 2 samples a byte, the high
    nibble the left channel.  All lanes in one `decode_ms_nibbles`."""
    dev = resolve_device(device)
    lanes = _lanes(data, channels, block_align, 7 * channels, _ms_lanes)
    if lanes is None:
        return _empty(channels, dev)
    sizes, (nib, c1, c2, idl, s1, s2) = lanes
    t = [upload(a, dev) for a in (nib, c1, c2, idl, s1, s2)]
    dec = K.decode_ms_nibbles(*t)
    head = torch.stack([t[4], t[5]]).to(torch.int16)          # [2, L]
    heads, row = [], 0
    for nb, _ in sizes:
        heads.append(head[:, row:row + nb * channels].reshape(
            2, nb, channels).transpose(0, 1))
        row += nb * channels
    pcm = _unlane(dec, sizes, channels, 1, heads)
    return pcm if channels > 1 else pcm[:, 0]
