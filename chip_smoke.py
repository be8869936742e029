#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (amv_tpu_torch) on one NVIDIA GPU and check
its paths end to end: the complete AMV->AMV transcode (with each of its
entropy encoders), the record-IR decode, the AMV decode (video and audio),
the AMV encode, the q60 quantizer, odd picture sizes, the served
transcode on CUDA streams, the encode's ingest (AVI input, -s
rescaling, -ar resampling, every WAVE format), the trellis quantizer
(-trellis, kernel L), baseline MJPEG in and out, progressive (SOF2) and
lossless (SOF3) MJPEG input, G.729A decoding (kernel G) with the ACT
routes, G.729A encoding (kernel K, and the host encoder behind `-f act`),
the pixel outputs (kernel Y, `.bmp`) and amvlib's decoder and API
(kernel W), and the sharding over a mesh of devices (parallel/sharding.py,
AsyncTranscoder(mesh=)).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
 1. the card: nvidia-smi name and power limit, torch.cuda required;
 2. build the seventeen CUDA sources from amv_tpu_torch/csrc (nvcc, sm_90a,
    one nvcc per source, all started together), and log the registers,
    spills and shared memory ptxas gives kernels D, E, Q, V, T, A, X, P,
    F, L, M, G, K, Y and W, and kernel T's SASS instructions (cuobjdump, static
    counts: one thread a block), logged in phase 4 with a static-count
    estimate of each T entry's issue time at its own blocks; G's source
    is also built with line information to a cubin beside the phases, for
    its latency floor in phase 15, and K's first design
    (tools/g729_encode_baseline.cu) into a library of its own, with it and
    K's source again with -DK_PHASES (the time by phase), for phase 16;
 3. a 160x120 corpus at the reference's canonical shape (16 fps, 22,050 Hz
    ADPCM audio): 4,800 frames (5 minutes) of seeded videogen/rotozoom
    pictures with noise, each C-encoded at qscale 2, muxed into an .amv
    with one encoded second of audio repeated; and 300 s of audiogen PCM
    for the encode path;
 4. each kernel against its plain torch version on the card, bit-exact,
    at the main paths' shapes, with each one's median time (CUDA events)
    beside the plain version's and its bound (the least time the card
    could take: the bytes it must move over the memory rate, or its
    integer operations over the peak rate, whichever is larger):
    D, T, E (and E's count entry) on the corpus as the transcode hands it
    over, with D's sync rounds per frame; I on the
    corpus blocks; F on the blocks of the raw corpus pictures; U (both
    entries) on the corpus levels and DC, un-sorting as the decode does;
    V on the raw corpus pictures (the path entry with each quantizer, the
    contract entry on their coded planes); A on the
    file's audio chunks; Q on the 300 s stream's chunk layout, with its
    passes' device times (torch.profiler) and one chunk's walk alone; R and X
    (the record decode) on the transcode's scans, in a budget no frame
    overflows; P on the record encoder's records of the re-encode levels;
    and the other entries over the same kernels: T's dequantized entry on
    the corpus's dequantized blocks and its wrap 64 times over the first
    N_CHECK frames' blocks, I's raw idct_put on the corpus's dequantized
    blocks, F's raster fdct_quantize, A's wrap entry 64 times over and Q's
    8 times over.  Then extra cases: malformed scans (D, R), kernel D's
    subsequence cases (data ending at and around subsequence boundaries,
    scans cut by 1-3 bytes, failures in the first and the last
    subsequence, a spent token budget, wider rows and so a larger
    subsequence), no edge replication (T), an overflowing word
    budget (E, P), kernel E's edges (a frame ending exactly at 32 w_out
    bits and one bit past, a w_out too large for shared memory, 320x240 and
    175x97 pictures, q60 flat frames), DC-only blocks
    (I), qscale 1 (F, V), flat frames at luma 0/255/128/13 under q60 (V),
    168x120 and an odd size (U, V), 168x120 (T, both entries), clamp-stress
    payloads (A), a stream
    with no reset at sample 0, one starting at step index 88 and 2 s as
    one segment (Q); R + X
    against D's levels, in the budget and in JAX's default one;
 5. the transcode through the user's entry point, amv_tpu_torch.cli.main:
    video byte-identical to the C reference transcode, audio passed
    through, D, T and E launched; frames/s and the split between the
    device chain and the host stages; then the record decode path
    (decode_scans_async: R and X launched, levels equal to D's) and the
    transcode's device chain with each entropy encoder (transcode_complete
    with enc = record, rechunk, parallel beside async): bytes equal to
    the C reference, P launched by record and rechunk, E by none of them,
    and each chain's time;
 6. the decode through cli.main, to .yuv and to .wav: every frame
    byte-identical to the C decoder, the PCM to the C ADPCM decoder chunk
    by chunk, D, U and A launched and not I; frames/s, Msamples/s and the
    split; the old chain (I + assembly) against the new (U), interleaved;
 7. the encode through cli.main from .yuv + .wav: every video chunk
    byte-identical to the C encoder, every audio chunk to the Python
    ADPCM oracle, V, E and Q launched and not F; frames/s, Msamples/s and
    the split; the old chain (extraction + F) against the new (V),
    interleaved; a zero-frame encode on the card equal to the CPU route's;
 8. -amv_quant q60 through cli.main: the encode and the transcode of the
    corpus (the two-stage route D, U, V, E; not T), frames/s; every q60
    payload decoded by the C decoder to the port's planes, Y round trips
    of at least 30 dB, the first 256 frames' bytes equal to the port's CPU
    route;
 9. 64 frames at 168x120 (width not whole MCUs) through the transcode
    (with each entropy encoder), the decode and the encode,
    byte-identical to C; then 64 frames at 175x97 (odd: the two-stage
    transcode, each entropy encoder) byte-identical to C, and their q60
    transcode and encode equal to the port's CPU route;
10. 256 frames at 320x240 through transcode_bytes and through the
    transcode's device chain with each entropy encoder, byte-identical to
    C;
11. serving: AsyncTranscoder (batches of 1,024 frames, 4 in flight, each
    on its own CUDA stream) over the corpus, byte-identical to C, its
    issue stage run under torch.cuda.set_sync_debug_mode("error") so any
    host sync there fails, D, T and E launched; its frames/s and the
    device's idle share (torch.profiler); cli.main on the corpus twice over
    (9,600 frames, over AMV_SERVE_THRESHOLD) through the served route and,
    with the threshold above the file, the whole-file route, byte-identical
    to C, with both frames/s; the whole-file route's stages one by one
    with the pinned copies and the packed escape;
12. ingest: a 5-minute AVI (4,800 frames of 320x240 I420 from 160 seeded
    pictures, tiled, and 44,100 Hz mono s16 PCM, 0.58 GB) through the
    reference's canonical `cli.main -i in.avi -f amv -r 16 -s 160x120 -ac 1
    -ar 22050` x3, frames/s: video byte-identical to the C encoder of the
    CPU route's scaled planes, audio to the ADPCM oracle of its resampled
    PCM, the card's scaled planes and PCM equal to the CPU route's, V, E
    and Q launched; the stages one by one (read, demux, host staging,
    host->device, unpack, scale, audio extract, resample, V, E count, E,
    device->host, escape, audio layout and copies, Q, mux); 64 frames of
    each raw AVI format (BGR24 and a colour pal8 at 330x240: padded rows)
    and each -sws_flags value on the card against the CPU route; 300 s of
    44,100 Hz stereo in each WAVE format (u8, s16, s24, s32, A-law, mu-law,
    IMA-WAV and MS-ADPCM at block_align 2,048) decoded on the card against
    the CPU route and, on the first 64 blocks, the scalar oracles, with
    Msamples/s; kernel A launched for IMA-WAV and kernel M for MS-ADPCM,
    M held against its plain version (the torch loop) on that stream's
    12,998 lanes of 2,034 samples;
13. trellis: the 300 s stream of phase 7 through cli.main -trellis x3
    (V, E, Q and L launched), Msamples/s; kernel L against its plain
    version on the card over all 4,800 chunks from the file's chunk
    starts (bytes and final states), the chain at its fixed point
    (each chunk's start the previous one's final), the rounds from kernel
    Q's guesses and the chain's time, the first 32 chunks equal to the
    numpy oracle (verify/ref_trellis.py), every chunk decoded by the C
    ADPCM decoder (SNR beside the greedy encoder's);
14. MJPEG ingest: a camera's 5-minute MJPG AVI (160 seeded 320x240
    pictures encoded on the card by encode_mjpeg_frames in 4:2:2 with a
    restart interval of 5 MCUs, F launched, tiled to 4,800 frames, and
    44,100 Hz PCM) through `cli.main -i cam.avi -f amv -r 16 -s 160x120
    -ac 1 -ar 22050 -trellis` x2 (two passes leave room for phase 18),
    frames/s: every frame through the host C scan decoder, I, V, E, Q
    and L launched; the card's decoded and scaled planes of the first 160
    frames equal the CPU route's, the
    video C's encode of them, the audio the trellis encode of the
    resampled PCM (first 8 chunks = the numpy oracle); F and I against
    their plain versions at this path's shapes; the stages one by one
    (read, demux, header parse, host C scan decode, dequant, I, assembly,
    4:2:0, scale, V, E, escape, audio, mux); a 4:2:0 `-vcodec mjpeg` file
    of the port decoded through kernel D; 64 frames of 4:2:0, 4:4:4 and
    gray with restart intervals 0 and 1, bytes and planes card = CPU;
15. G.729A: 1,024 recordings of 60 s (6,000 seeded frames each: 1%
    erasures, 1% bad parity, 5% pitch codes >= 197; one stream at the
    largest pitch gain, whose LP synthesis overflows, one with the least
    pitch code) through decode_streams on the card, kernel G launched
    once (its launches counted from 0): its time beside its bounds (bytes
    and operations, and the latency floor: the longest pipeline stage's
    dependent chain a frame in the nvdisasm listing of the cubin built in
    phase 2, time_g729.g729_floor, at the card's highest SM clock),
    frames/s and the real-time factor; G against its
    plain version on the card, PCM and state, for every stream's first
    16 frames and two windows of 16 in the middle, each from the state G
    returned at that frame; two streams' first 200 frames against the
    scalar oracle (verify/ref_g729.py); a 10-minute .act file (stream 0's
    frames 10 times, act.mux) through `cli.main -i rec.act out.wav` x3 (G
    launched once a pass; its first 6,000 frames equal stream 0 of the
    batch) and out.bit (the frames' bits), with frames/s, the stages one
    by one (read, demux, upload + unpack, G, write);
16. G.729A encoding: 1,024 seeded speech recordings of 6 s (600 frames
    each) through encode_streams on the card, kernel K launched once (its
    launches counted from 0): its time beside its bound (float operations
    a frame, counted from g729_encode.cu, over the FP32 lanes' rate: each
    multiply and add its own instruction under -fmad=false; the shared
    loads over the load units' rate beside it), frames/s; K in turns with
    its first design (baseline, K, K, baseline; outputs equal) at 1,024 x
    600, and both designs' time by phase on one line each;
    K against its plain version on the card (parameters, state and hist)
    for every stream's first 8 frames and a window of 8 mid-stream from
    K's returned state; the frames decoded by G to K's shadow state;
    decode(encode(x))'s corr and segSNR; then `cli.main -i speech.wav -f
    act --max-frames 16` on a 22,050 Hz stereo WAV (the host encoder after
    the resampling on the card), timed, its file decoded by G against the
    resampled mono input (16 frames and K's turns at one shape, which
    leave room for phase 18);
17. (run after phase 4, on the corpus of phase 3: 4,800 frames) pixel
    outputs and amvlib:
    kernel Y against its plain version, bit for bit, in all 15 formats
    (and the 16-bit ones undithered, rgb24 in limited range, rgb24, rgb32
    and rgb565 at a key of brightness, contrast and saturation that sends
    the last two to the tables path), YUYV/UYVY on
    the card against the CPU, each format's first 4 frames against the
    scalar oracle (verify/ref_yuv2rgb.py, in 4 worker processes); kernel
    W's planes and RGB entries against their plain versions on every
    frame, and its RGB entry at one frame; each with its median time
    (CUDA events), device time (torch.profiler), its time in bursts of 20
    launches, bound and ptxas lines;
    cli.main -pix_fmt rgb24 out.rgb, -pix_fmt rgb565 out.raw and
    f_%04d.bmp under --color bt601 and amvlib, each timed (D, U and Y
    launched for the pixel dumps) and split by stage (read + demux, device
    decode, Y or color, device->host, write); AmvOpen ->
    AmvReadNextFrame / AmvVideoDecode over every frame on the card (D and
    W once a frame), frames/s, the first 64 equal to the batch decode
    decode_frames_amvlib_rgb;
18. (run after phase 14, on 8 of its pictures) progressive and lossless
    MJPEG input: the pictures encoded by the port, progressive (the
    coefficients of the baseline encode at qscale 2, Al 1 and refinement
    scans) and lossless (4:2:0, predictor 1), in 4 worker processes, each
    set tiled to a 5-minute 4,800-frame MJPG AVI with 44,100 Hz PCM
    (prog.avi, ll.avi) through `cli.main -i X.avi -f amv -r 16 -s 160x120
    -ac 1 -ar 22050` x3, frames/s: I, V, E, Q launched for SOF2, V, E, Q
    and not I for SOF3; the card's planes of the 8 distinct frames equal
    the CPU route's, the progressive ones the baseline decode of the same
    coefficients (through D), the lossless ones the pictures and the
    plain Python walk's (in the workers); video equal to the C encoder of
    the scaled planes, audio to the CPU route's; each file's stages one
    by one (read, demux, header parse, host C walk on 8 threads, upload,
    dequant, I, assembly, 4:2:0, scale, V, E, escape, audio, mux); 64
    check frames at 96x64, card = CPU (predictors 1-7 and point transform
    2, restart interval 1, RGB plain, RCT and Pegasus, progressive Al 0
    and 2, per-scan Huffman table redefinition); I against its plain
    version at a 1,024-frame 4:2:0 320x240 batch;
19. (run after phase 11) multi-GPU sharding: every sharded_* function of
    parallel/sharding.py on a virtual mesh of 4 positions of the card (dp 2
    x sp 2, a stream each) against the single-device function, bit for
    bit, at small shapes (the corpus's first 64 frames: the decode step
    with frames on dp and MCUs on sp, so the DC carry crosses the sp
    shards; random ADPCM chunks and streams; 8 G.729A streams of 16
    frames), the kernels they launch counted; AsyncTranscoder(mesh= 2
    positions of the card) over the corpus twice (9,600 frames), bytes
    equal to phase 11's, frames/s (x3) as a one-card virtual mesh's; with
    two or more cards, the same on a mesh of every card, else a line that
    no second card was present.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

N_FRAMES, W, H, FPS, RATE, QSCALE = 4800, 160, 120, 16, 22050, 2
N_CHECK = 512
N_PAD, W_PAD = 64, 168          # 168 = 10.5 MCUs: right-hand pad columns
# an odd size: 97 = 16 * 6 + 1 rows leave the last MCU row 48 chroma rows,
# none in its own MCU row (kernel T refuses it; the two-stage route runs)
ODD_W, ODD_H = 175, 97
N_CPU = 256                     # q60 frames also run on the port's CPU route
WRAP = 64                       # kernel A's wrap entry: the chunks 64 times

# The card's peaks are amv_tpu_torch/utils/roofline.py's (`bound` below).
# Integer operations per unit of work, counted from the CUDA sources
# (multiplies, adds, shifts, compares, selects; loads and stores not):
OPS_DEQUANT = 190    # dct.cuh callers: Q60 dequant and the DC slot
OPS_IDCT = 1410      # dct.cuh: simple_idct row pass 600 + column pass 810
OPS_FDCT = 1600      # dct.cuh: two jfdctint passes 1,200 + quantizer 400
OPS_FDCT_Q60 = 3100  # the passes 1,200 + the q60 quantizer: 64 x (a divide
                     # by a run-time divisor ~20 + ~10 others)
Q_WRAP = 8           # kernel Q's wrap entry: the stream 8 times
OPS_TOKEN = 20       # a Huffman token: peek, table walk, extend, store
OPS_EXPAND = 15      # an ADPCM decode sample (adpcm_decode.cu expand)
OPS_COMPRESS = 25    # an ADPCM encode sample (adpcm_encode.cu compress)
OPS_SCATTER = 8      # a record expanded (record_expand.cu)
OPS_RECORD = 12      # a record packed (record_pack.cu: its length in the
                     # scan, the code's mask and shifts, one or two ORs)
OPS_MS = 13          # an MS-ADPCM sample (adpcm_ms.cu: the predictor's two
                     # products, the / 256, the sign, the sum, the clip, the
                     # adaptation product, shift and floor)
OPS_EDGE = 16        # a trellis in-edge (the predictor's add and clip, the
                     # error and its square, the int64 sum, the unreachable
                     # test, the compare and 3 selects: the bound's yardstick)
EDGES = 1424         # in-edges of the 89 states a sample (89 x 16)
EDGES_EVALUATED = 1157   # of them, the errors kernel L forms (89 x 13: its
                         # index -1 move's far group needs m = 0 alone)
N_ORACLE = 32        # trellis chunks held against the numpy oracle
# phase 15, G.729A: a dictaphone's recordings in bulk and one 10-minute file
G_STREAMS, G_FRAMES = 1024, 6000     # 1,024 recordings of 60 s
G_FILE_REPS = 10                     # stream 0's frames 10 times: 10 min
G_CHECK = 16                         # frames of each window held to plain
G_ORACLE = 200                       # frames of 2 streams held to the oracle
# kernel G's integer operations a frame, counted from g729_decode.cu:
# the interpolation 6,400, LP syntheses 4,000, the residual FIR 2,400, the
# long-term filter 5,300, tilt 1,700, the energy sums 720, the excitation
# update 640, the high-pass 960, the AGC 480, LSF/LSP/LP and gains 1,600
OPS_G729 = 24200
# phase 16, G.729A encoding: a dictaphone's library of recordings in bulk
K_STREAMS, K_FRAMES = 1024, 600      # 1,024 recordings of 6 s
K_CHECK = 8                          # frames of each window held to plain
K_CLI_FRAMES = 16                    # frames of cli.main -f act (host)
K_TURNS = ((1024, 600),)             # K in turns with its first design
# kernel K's float operations a frame, counted from g729_encode.cu (a
# multiply, add, compare, select, division, square root or sign flip each
# one).  The analysis: the window, the autocorrelation's 11 x 240
# multiply-adds, Levinson, the grid's 1,024 points at 38 (cos5 26, the sum
# 11, the point), the sign changes, 10 roots x 12 bisection steps at 44,
# the LSF targets and sort, the first stage's 256 x 10 distances, the 8
# least, the second stage's 1,024 x 5, its minima, the exact errors:
K_ANALYSIS = (240 + 11 * 240 * 2 + 250 + 40 + 1024 * 38 + 511 * 4
              + 10 * 12 * 44 + 85 + 80 + 256 * 10 * 3 + 224 + 1024 * 5 * 4
              + 32 * 31 + 16 * 80)
# a pitch candidate: 820 products and 780 sums through the impulse
# response, its two 40-term scores and the score; the candidates that may
# be coded: 253 in subframe 0, 30 in subframe 1
K_CANDIDATE = 820 + 780 + 40 * 4 + 4
K_CANDIDATES = 253 + 30
# a subframe besides its candidates: the impulse and zero-input responses,
# the upsampled history (432 x 20 multiply-adds), the chosen vector's
# response and gain, the sharpened response, the residual target, d, the
# matrix's 40 diagonals (820 multiply-adds) and its 1,600 sign flips, the
# 8,192 pulse combinations at 12 (the prefixes: 3 a track-2 position of
# the 64 track-0/1 pairs, 2 a pair), the code vector's response, the 128
# gain pairs and 3 correlations:
K_SUBFRAME = (20 + 729 + 880 + 432 * 41 + 820 * 2 + 165 + 120 + 80
              + 820 * 2 + 820 * 2 + 1600 + 8192 * 12 + 512 * 3 + 64 * 2
              + 820 * 2 + 128 * 16 + 3 * 80)
OPS_G729_ENCODE = K_ANALYSIS + 2 * K_SUBFRAME + K_CANDIDATES * K_CANDIDATE
# its shared-memory loads a frame (32-bit lanes), counted likewise: the
# candidates' vectors and targets (283 x 80) and each thread's impulse
# response (2 x 40 x 64 threads), the ACELP's 1 a combination, 4 a
# track-2 position and 69 a thread (2 x (8,192 + 2,048 + 4,416)), the
# interpolation's history (2 x 8,640), the matrix and the correlations
# (d, y_ac, y_fc and the diagonals: 2 x 4 x 1,640), the analysis
# (autocorrelation 5,280, grid 6,144, the quantizer's distances 7,680)
LDS_G729_ENCODE = (K_CANDIDATES * 80 + 2 * 40 * 64
                   + 2 * (8192 + 2048 + 4416) + 2 * 8640 + 2 * 4 * 1640
                   + 5280 + 6144 + 7680)

# phase 17, pixel outputs and amvlib, on the corpus of phase 3
OPS_PIXEL = 30       # a packed pixel (yuv2rgb_packed.cu: 3 table indices,
                     # clamps and reads, the offsets' adds, sum and pack)
OPS_AMVLIB = 1300    # an amvlib block (amvlib_idct.cu: 64 dequant products,
                     # 8 rows of ~63 and 8 columns of ~86 operations, the
                     # +128, the DC scan and the store's index arithmetic)
Y_ORACLE = 4         # frames of each format held to the scalar oracle

# phase 18, progressive and lossless MJPEG: distinct pictures of phase 14
PROG_UNIQUE = 8

# phase 12, ingest: a 5-minute capture of 320x240 I420 frames and 44,100 Hz
# PCM through the reference's canonical `-s 160x120 -ar 22050`
AVI_W, AVI_H, AVI_RATE = 320, 240, 44100
N_UNIQUE = 160       # distinct seeded pictures, tiled to N_FRAMES
N_FMT = 64           # frames of each raw AVI format, each -sws_flags value
WAV_S = 300.0        # seconds of 44,100 Hz stereo in each WAVE format
WAV_BLOCK = 2048     # IMA-WAV's and MS-ADPCM's block_align
INGEST_FORMATS = (   # (fourcc, bits, width, colour palette, RGB16 masks)
    (b"I420", 12, 320, False, None), (b"IYUV", 12, 320, False, None),
    (b"YV12", 12, 320, False, None), (b"YUY2", 16, 320, False, None),
    (b"YUYV", 16, 320, False, None), (b"V422", 16, 320, False, None),
    (b"YUNV", 16, 320, False, None), (b"UYVY", 16, 320, False, None),
    (b"Y422", 16, 320, False, None), (b"UYNV", 16, 320, False, None),
    (b"Y800", 8, 320, False, None), (b"GREY", 8, 320, False, None),
    (b"DIB ", 8, 320, False, None), (b"DIB ", 8, 330, True, None),
    (b"DIB ", 16, 320, False, None),
    (b"DIB ", 16, 320, False, (0xF800, 0x07E0, 0x001F)),
    (b"DIB ", 24, 330, False, None), (b"DIB ", 32, 320, False, None))
SWS_FLAGS = ("bilinear", "bicubic", "point", "area", "lanczos", "gauss",
             "sinc", "spline", "experimental", "bicublin")


def log(msg: str) -> None:
    print(msg, flush=True)


def import_port() -> SimpleNamespace:
    """The port's modules this script drives; nothing of JAX or amv_tpu."""
    from amv_tpu_torch import amvlib_api, cli, native, pipeline
    from amv_tpu_torch.codecs import amv_audio, amv_video, jpeg_tables
    from amv_tpu_torch.codecs import amvlib_video
    from amv_tpu_torch.codecs import g729a, mjpeg, wav_audio
    from amv_tpu_torch.codecs import g729a_encoder_batch as g729_enc
    from amv_tpu_torch.bitstream import jpeg_lossless, jpeg_parse
    from amv_tpu_torch.bitstream import jpeg_progressive
    from amv_tpu_torch.containers import act, avi, riff, wav
    from amv_tpu_torch.kernels import _build, adpcm, fdct, idct
    from amv_tpu_torch.kernels import g729 as G
    from amv_tpu_torch.kernels import adpcm_trellis as L
    from amv_tpu_torch.kernels import color, resample, scale
    from amv_tpu_torch.kernels import decode_fused as U
    from amv_tpu_torch.kernels import encode_fused as V
    from amv_tpu_torch.kernels import entropy_decode as D
    from amv_tpu_torch.kernels import entropy_encode as E
    from amv_tpu_torch.kernels import entropy_parallel as EP
    from amv_tpu_torch.kernels import entropy_records as R
    from amv_tpu_torch.kernels import record_pack as RP
    from amv_tpu_torch.kernels import transcode as T
    from amv_tpu_torch.kernels import yuv2rgb_dither as Y
    from amv_tpu_torch.parallel import sharding
    from amv_tpu_torch.pipeline import decode, encode
    from amv_tpu_torch.pipeline import serving as S
    from amv_tpu_torch.pipeline import transcode as P
    from amv_tpu_torch.tools import time_g729 as tools_g
    from amv_tpu_torch.tools import time_serving as tools_s
    from amv_tpu_torch.tools import time_transcode_kernel as tools_t
    from amv_tpu_torch.utils import roofline
    from amv_tpu_torch.verify import fixtures, ref_adpcm, ref_g729
    from amv_tpu_torch.verify import ref_jpeg, ref_trellis
    from amv_tpu_torch.verify import ref_wav_audio, ref_yuv2rgb
    return SimpleNamespace(**locals())


def pictures(m, n, h, w, seed):
    """n seeded YUV420 pictures: videogen and rotozoom, interleaved in
    runs of 16, with +-3 luma noise."""
    rng = np.random.default_rng(seed)
    half = n // 2
    vg = m.fixtures.videogen(half, h, w, seed=seed)
    rz = m.fixtures.rotozoom(n - half, h, w)
    y = np.empty((n, h, w), np.uint8)
    cb = np.empty((n, h // 2, w // 2), np.uint8)
    cr = np.empty_like(cb)
    for i in range(n):
        src = vg if (i // 16) % 2 == 0 else rz
        k = i // 32 * 16 + i % 16
        y[i] = np.clip(src[0][k].astype(np.int16) +
                       rng.integers(-3, 4, src[0][k].shape), 0, 255)
        cb[i] = src[1][k][:h // 2, :w // 2]
        cr[i] = src[2][k][:h // 2, :w // 2]
    return y, cb, cr


def c_encode(m, pics):
    return [m.native.ref_encode_frame(pics[0][i], pics[1][i], pics[2][i],
                                      QSCALE) for i in range(len(pics[0]))]


def c_transcode(m, pays, w, h):
    return [m.native.ref_encode_frame(*m.native.ref_decode_frame(p, w, h),
                                      QSCALE) for p in pays]


def c_decode_matches(m, pays, w, h, y, cb, cr) -> None:
    for i, p in enumerate(pays):
        ry, rcb, rcr = m.native.ref_decode_frame(p, w, h)
        if not (np.array_equal(y[i], ry) and np.array_equal(cb[i], rcb)
                and np.array_equal(cr[i], rcr)):
            raise AssertionError(f"{w}x{h} frame {i} differs from the C "
                                 "decoder")


def cuda_ms(fn, reps, warmup=True):
    """(median milliseconds of fn() on the current stream (CUDA events),
    the last call's result); one warm-up call first unless warmup=False."""
    import torch
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


Q_PASSES = (("pass 1", ("window_ends",)),
            ("pass 2", ("group_maps", "group_chain", "window_chain")),
            ("pass 3", ("window_encode",)))


def q_passes(fn, reps=10):
    """Device milliseconds per call of fn (kernel Q's wrapper) by pass, from
    torch.profiler's kernel times: Q's three passes and the rest (the
    counters' memset and any torch work of the wrapper, "other")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k, _ in Q_PASSES}
    out["other"] = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        us = getattr(ev, "cuda_time_total", 0) if us is None else us
        if us <= 0:
            continue
        key = next((k for k, names in Q_PASSES
                    if any(nm in ev.key for nm in names)), "other")
        out[key] += us / 1e3 / reps
    assert out["pass 1"] > 0 and out["pass 3"] > 0, \
        f"torch.profiler saw no device time for kernel Q's passes: {out}"
    return out


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over pairs of integer tensors; raises if
    shapes or dtypes differ."""
    err = 0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        if got.numel():
            err = max(err, int((got.long() - want.long()).abs().max()))
    return err


def bound(nbytes: float, ops: float, fp32: bool = False):
    """(bound in ms, what bounds it) for a function that moves nbytes and
    does ops integer operations, or ops unfused FP32 instructions where
    fp32 (`roofline.bound_ms`)."""
    from amv_tpu_torch.utils.roofline import bound_ms
    return bound_ms(nbytes, 0 if fp32 else ops, ops if fp32 else 0)


def staged(split, name, fn):
    """Run fn, synchronize, and add its host-clock seconds to split."""
    import torch
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    split[name] = time.perf_counter() - t
    return r


def log_split(what, split, extra=""):
    total = sum(split.values())
    dev = sum(v for k, v in split.items() if k.startswith("device"))
    log(f"{what} split (s): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in split.items())
        + f"; device {dev / total:.1%} of {total:.3f}{extra}")


def timed_cli(m, argv, runs=3):
    """Median wall seconds of cli.main(argv) over `runs` passes, and the
    walls."""
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        rc = m.cli.main(argv)
        walls.append(time.perf_counter() - t0)
        assert rc == 0, argv
    return statistics.median(walls), walls


def ptxas_start(m):
    """nvcc -Xptxas -v of kernels D's and R's, E's, Q's, V's, T's, A's, X's,
    P's, F's, L's, M's, G's, K's, Y's and W's sources, started beside the
    build (the object goes nowhere)."""
    return m.tools_t.ptxas_start(m._build, (
        "entropy_decode.cu", "entropy_encode.cu", "adpcm_encode.cu",
        "encode_fused.cu", "transcode.cu", "adpcm_decode.cu",
        "record_expand.cu", "record_pack.cu", "fdct.cu", "adpcm_trellis.cu",
        "adpcm_ms.cu", "g729_decode.cu", "g729_encode.cu",
        "yuv2rgb_packed.cu", "amvlib_idct.cu"))


def ptxas_log(m, procs) -> dict:
    """Each kernel's registers, spills and shared memory, as ptxas says
    (stack and spill lines only where they are not all 0); returns
    {source: lines}."""
    lines_of = m.tools_t.ptxas_lines(procs)
    for name, lines in lines_of.items():
        for line in lines:
            if not line.split(": ", 1)[1].startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes"):
                log(f"ptxas {name} {line}")
    return lines_of


def reset_launches(m):
    m.D.LAUNCHES = m.T.LAUNCHES = m.E.LAUNCHES = m.E.COUNT_LAUNCHES = 0
    m.idct.LAUNCHES = m.fdct.LAUNCHES = m.U.LAUNCHES = m.V.LAUNCHES = 0
    m.adpcm.DECODE_LAUNCHES = m.adpcm.ENCODE_LAUNCHES = 0
    m.R.RECORD_LAUNCHES = m.R.EXPAND_LAUNCHES = m.RP.LAUNCHES = 0
    m.L.LAUNCHES = m.adpcm.MS_LAUNCHES = m.G.LAUNCHES = 0
    m.G.ENCODE_LAUNCHES = m.Y.LAUNCHES = m.amvlib_video.LAUNCHES = 0


def launches(m):
    return {"D": m.D.LAUNCHES, "T": m.T.LAUNCHES, "E": m.E.LAUNCHES,
            "E count": m.E.COUNT_LAUNCHES,
            "I": m.idct.LAUNCHES, "F": m.fdct.LAUNCHES,
            "U": m.U.LAUNCHES, "V": m.V.LAUNCHES,
            "A": m.adpcm.DECODE_LAUNCHES, "Q": m.adpcm.ENCODE_LAUNCHES,
            "R": m.R.RECORD_LAUNCHES, "X": m.R.EXPAND_LAUNCHES,
            "P": m.RP.LAUNCHES, "L": m.L.LAUNCHES,
            "M": m.adpcm.MS_LAUNCHES, "G": m.G.LAUNCHES,
            "K": m.G.ENCODE_LAUNCHES, "Y": m.Y.LAUNCHES,
            "W": m.amvlib_video.LAUNCHES}


def route_bytes(m, pays, w, h, enc):
    """The video chunks of transcode_complete(enc=...) over payloads,
    length-sorted as transcode_bytes sorts them."""
    import torch
    rows, lens = m.native.unescape_frames(pays)
    order = np.argsort([len(p) for p in pays], kind="stable")
    n_mcu = ((w + 15) // 16) * ((h + 15) // 16)
    words, bits, ok = m.P.transcode_complete(
        torch.from_numpy(rows[order]).cuda(),
        torch.from_numpy(lens[order]).cuda(), n_mcu, QSCALE, (w, h), enc=enc)
    assert ok.all()
    inv = np.argsort(order)
    return m.native.escape_frames(words.cpu().numpy()[inv],
                                  bits.cpu().numpy()[inv])


def check_routes(m, pays, w, h, want) -> None:
    """Every entropy encoder's bytes equal the C reference's, and kernel E
    runs in none but "async"."""
    for enc in m.P.ENCODERS:
        e0 = m.E.LAUNCHES
        assert route_bytes(m, pays, w, h, enc) == want, (enc, w, h)
        assert (m.E.LAUNCHES > e0) == (enc == "async"), (enc, "kernel E")


def d_cases(m, rows, lens, nb, rng):
    """Kernel D's subsequence cases on corpus scans (S is 1,024 bits, 128
    bytes, for rows up to 16 KB): (name, rows, lens, budget or None)."""
    import torch
    n = len(rows)
    out = []
    r, ln = rows.copy(), lens.copy()
    for f in range(n):                   # data ending on and around 128 k
        ln[f] = min(int(lens[f]), 128 * (1 + f // 3)) + f % 3 - 1
    out.append(("boundaries", r, ln, None))
    out.append(("cut", rows, lens - (np.arange(n) % 3 + 1), None))
    r = rows.copy()
    r[::2, 3:7] = 0xFF
    out.append(("fail_first", r, lens, None))
    r = rows.copy()
    for f in range(0, n, 2):
        at = min((8 * int(lens[f]) - 1) // 1024 * 128 + 2, int(lens[f]) - 4)
        r[f, at:at + 4] = 0xFF
    out.append(("fail_last", r, lens, None))
    budget = m.D.token_budget(torch.from_numpy(lens), nb, rows.shape[1])
    budget[::2] = torch.from_numpy(rng.integers(1, 900, (n + 1) // 2))
    out.append(("budget", rows, lens, budget))
    for stride in (20000, 170000):       # wider strides: a larger S
        wide = np.zeros((n, stride), np.uint8)
        wide[:, :rows.shape[1]] = rows
        out.append((f"stride {stride}", wide, lens, None))
    return out


def e_fit(m, lv, target):
    """lv's frame 0 with levels zeroed from its end until its bits are
    target mod 32 -> (levels, its bits)."""
    lv = lv.clone()
    bits = int(m.E.count_bits_plain(lv[:1])[0])
    for b in range(lv.shape[1] - 1, 0, -1):
        for k in range(63, 0, -1):
            if bits % 32 == target:
                return lv, bits
            if lv[0, b, k]:
                lv[0, b, k] = 0
                bits = int(m.E.count_bits_plain(lv[:1])[0])
    raise AssertionError("no fit found")


def rand_levels(rng, n_blocks, dense=0.15):
    """Sparse levels int16 [n_blocks, 64] in +-1023, some blocks saturated."""
    lv = np.where(rng.random((n_blocks, 64)) < dense,
                  rng.integers(-1023, 1024, (n_blocks, 64)), 0)
    lv[rng.random(n_blocks) < 0.05] = 1023
    return lv.astype(np.int16)


def interleaved(fns, rounds=4):
    """Median milliseconds (CUDA events) of each of fns, run in turns:
    forward in even rounds, backward in odd ones, after one warm-up."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(cuda_ms(fns[k], 1, warmup=False)[0])
    return {k: statistics.median(v) for k, v in times.items()}


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def serving_phase(m, dev, pays, want, audio, data, paths) -> None:
    """Phase 11: AsyncTranscoder over the corpus (batches of 1,024 frames,
    4 in flight; issue under set_sync_debug_mode("error")), its frames/s
    and the device's idle share; cli.main on the corpus twice over through
    the served and the whole-file routes; the whole-file route's stages
    with the pinned copies and the packed escape."""
    import torch
    cuda = dev.type == "cuda"
    n_mcu = ((W + 15) // 16) * ((H + 15) // 16)

    def server():
        return m.S.AsyncTranscoder(n_mcu, QSCALE, batch_frames=1024,
                                   depth=4, size=(W, H), device=dev)

    tr = server()
    issue = tr.issue

    def strict_issue(chunk):
        """issue with any host sync an error"""
        torch.cuda.set_sync_debug_mode("error")
        try:
            return issue(chunk)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    tr.issue = strict_issue
    torch.cuda.synchronize()
    reset_launches(m)
    got = tr.transcode(pays)
    paths["serving"] = launches(m)
    assert got == want, "served payloads differ from the C reference"
    assert all(paths["serving"][k] > 0 for k in "DTE") and \
        paths["serving"]["U"] == paths["serving"]["V"] == 0, paths
    walls_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        assert server().transcode(pays) == want
        walls_s.append(time.perf_counter() - t0)
    wall_s = statistics.median(walls_s)
    idle, wall_p = m.tools_s.idle_share(lambda: server().transcode(pays),
                                        dev)
    log(f"serving: AsyncTranscoder(batch_frames=1024, depth=4) over "
        f"{N_FRAMES} frames: byte-identical to the C reference, issue under "
        f"set_sync_debug_mode('error'); launches {paths['serving']}; "
        f"{', '.join(f'{t:.3f}' for t in walls_s)} s, median {wall_s:.3f} s"
        f" = {N_FRAMES / wall_s:.1f} frames/s; device idle share "
        f"{idle:.1%} of a profiled pass of {wall_p:.3f} s (torch.profiler: "
        "1 - the union of the device's kernel, copy and memset intervals "
        "over the wall)")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "long.amv")
        dst = os.path.join(tmp, "out.amv")
        with open(src, "wb") as f:
            f.write(m.riff.mux(pays + pays, audio + audio, width=W, height=H,
                               fps=FPS, sample_rate=RATE))
        argv = ["-i", src, "-f", "amv", dst, "--device", str(dev)]
        fps_route = {}
        for route, threshold in (("served", None),
                                 ("whole-file", str(4 * N_FRAMES))):
            if threshold is None:
                os.environ.pop("AMV_SERVE_THRESHOLD", None)
            else:
                os.environ["AMV_SERVE_THRESHOLD"] = threshold
            m.cli.main(argv)                                     # warm-up
            torch.cuda.synchronize()
            reset_launches(m)
            wall_r, walls_r = timed_cli(m, argv)
            paths[f"transcode {route}"] = launches(m)
            with open(dst, "rb") as f:
                out = m.riff.demux(f.read())
            assert out.video_chunks == want + want, route
            assert out.audio_chunks == audio + audio, route
            assert all(paths[f"transcode {route}"][k] > 0 for k in "DTE")
            fps_route[route] = 2 * N_FRAMES / wall_r
            log(f"transcode {route}: cli.main x3 on {2 * N_FRAMES} frames "
                f"(AMV_SERVE_THRESHOLD {threshold or 'unset: 8192'}) in "
                f"{', '.join(f'{t:.3f}' for t in walls_r)} s, median "
                f"{wall_r:.3f} s = {fps_route[route]:.1f} frames/s; "
                f"byte-identical to the C reference; launches "
                f"{paths[f'transcode {route}']}")
        os.environ.pop("AMV_SERVE_THRESHOLD", None)
    log(f"transcode of {2 * N_FRAMES} frames: served "
        f"{fps_route['served']:.1f} frames/s, whole-file "
        f"{fps_route['whole-file']:.1f} frames/s")
    # the whole-file route's stages one by one: the pinned copies and the
    # packed escape (phase 5's split ran the pageable copies and the
    # per-frame escape)
    split = {}
    s = staged(split, "demux", lambda: m.riff.demux(data))
    n_v, stride = len(s.video_chunks), m.native.row_stride(s.video_chunks)
    rows_h, lens_h = staged(split, "pinned_alloc", lambda: (
        torch.empty(n_v * stride, dtype=torch.uint8, pin_memory=cuda),
        torch.empty(n_v, dtype=torch.int64, pin_memory=cuda)))
    staged(split, "unescape", lambda: m.native.unescape_into(
        s.video_chunks, rows_h.numpy(), lens_h.numpy()))
    r_t, l_t = staged(split, "to_device", lambda: (
        rows_h.view(n_v, stride).to(dev, non_blocking=True),
        lens_h.to(dev, non_blocking=True)))

    def chain():
        lv2, ok = m.P.transcode_scans(r_t, l_t, n_mcu, QSCALE, (W, H))
        bits = m.E.count_bits(lv2)
        assert bool(ok.all())
        w_used = m.amv_video.used_words(bits.cpu())
        return m.E.encode_levels(lv2, w_used)[0], bits

    words, bits = staged(split, "device_chain", chain)
    w_h = torch.empty(words.shape, dtype=torch.int32, pin_memory=cuda)
    b_h = torch.empty(bits.shape, dtype=torch.int32, pin_memory=cuda)
    staged(split, "to_host", lambda: (w_h.copy_(words, non_blocking=True),
                                      b_h.copy_(bits, non_blocking=True)))
    buf, offsets, lens_e = staged(split, "escape", lambda: (
        m.native.escape_packed(w_h.numpy(), b_h.numpy())))

    def mux():
        mv = memoryview(buf)
        return m.riff.mux([mv[o:o + k] for o, k in zip(offsets.tolist(),
                                                      lens_e.tolist())],
                          s.audio_chunks, width=W, height=H, fps=FPS,
                          sample_rate=RATE)

    staged_out = staged(split, "mux", mux)
    assert m.riff.demux(staged_out).video_chunks == want
    log_split("transcode (pinned copies, packed escape)", split,
              f"; words copied to the host {tuple(words.shape)}")


def wav_streams(seconds, rng):
    """{name: (format tag, bits, block_align, bytes)}: `seconds` of 44,100
    Hz stereo in each WAVE format the ingest decodes, from seeded random
    bytes (every byte pattern is a valid sample or nibble); the ADPCM
    blocks' headers are set in range (IMA step index 0-99, MS predictor
    0-6 and idelta -200-4,000)."""
    n = int(seconds * AVI_RATE) * 2                 # both channels' samples
    out = {name: (fmt, bits, bits // 4, rng.integers(
        0, 256, n * bits // 8, dtype=np.uint8).tobytes())
        for name, fmt, bits in (("u8", 1, 8), ("s16", 1, 16), ("s24", 1, 24),
                                ("s32", 1, 32), ("alaw", 6, 8),
                                ("mulaw", 7, 8))}
    ima = rng.integers(0, 256, (-(-n // (2 * (WAV_BLOCK - 8))), WAV_BLOCK),
                       dtype=np.uint8)
    ima[:, [2, 6]] = rng.integers(0, 100, (len(ima), 2))
    ima[:, [3, 7]] = 0
    out["ima"] = (0x11, 4, WAV_BLOCK, ima.tobytes())
    ms = rng.integers(0, 256, (-(-n // (2 * (WAV_BLOCK - 14) + 4)),
                               WAV_BLOCK), dtype=np.uint8)
    ms[:, :2] = rng.integers(0, 7, (len(ms), 2))
    ms[:, 2:6] = rng.integers(-200, 4000, (len(ms), 2)).astype(
        "<i2").view(np.uint8)
    out["ms"] = (2, 4, WAV_BLOCK, ms.tobytes())
    return out


def wav_oracle(m, fmt, bits, ba, data, n_blocks):
    """The port's scalar oracles on a stream's first n_blocks blocks (of
    block_align bytes for ADPCM; of WAV_BLOCK stereo samples for PCM):
    int16 [samples, 2]."""
    if fmt in (2, 0x11):
        return m.ref_wav_audio.decode_blocks(
            data[:n_blocks * ba], 2, ba, "ima" if fmt == 0x11 else "ms")
    w = bits // 8
    b = np.frombuffer(data, np.uint8, min(len(data) // (2 * w),
                                          n_blocks * WAV_BLOCK) * 2 * w)
    if fmt in (6, 7):
        table = m.ref_wav_audio.ALAW_TABLE if fmt == 6 else \
            m.ref_wav_audio.ULAW_TABLE
        return table[b].reshape(-1, 2)
    if bits == 8:                                  # pcm.c: (x - 128) << 8
        return ((b.astype(np.int16) - 128) << 8).reshape(-1, 2)
    # pcm.c decode_to16: the top 16 bits of each sample
    return b.reshape(-1, w)[:, w - 2:].copy().view("<i2").reshape(-1, 2)


def ingest_phase(m, dev, paths, card, check, n_frames=N_FRAMES,
                 n_unique=N_UNIQUE, n_fmt=N_FMT, wav_s=WAV_S) -> None:
    """Phase 12: an AVI of n_frames 320x240 I420 frames (n_unique seeded
    pictures, tiled) and mono s16 PCM at 44,100 Hz through the canonical
    `-f amv -r 16 -s 160x120 -ac 1 -ar 22050` (cli.main x3): video equal to
    the C encoder on the CPU route's scaled planes, audio to the ADPCM
    oracle on its resampled PCM, the card's planes and PCM equal to the
    CPU route's, V, E and Q launched; the stages one by one; each raw AVI
    format and each -sws_flags value on the card against the CPU route;
    each WAVE format's decode against the CPU route and the scalar
    oracles, with its Msamples/s; kernel M launched by the MS-ADPCM decode
    and held against its plain version (`check`) on that stream's lanes."""
    import torch
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t12 = time.perf_counter()
    pics = pictures(m, n_unique, AVI_H, AVI_W, seed=3)
    reps = -(-n_frames // n_unique)
    tiled = [np.concatenate([p] * reps)[:n_frames] for p in pics]
    pcm_in = m.fixtures.audiogen(n_frames / FPS, AVI_RATE, seed=3)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.avi"), os.path.join(tmp, "out.amv")
        with open(src, "wb") as f:
            f.write(m.avi.mux(*tiled, pcm_in, fps=FPS, sample_rate=AVI_RATE))
        size = os.path.getsize(src)
        del tiled
        warm = os.path.join(tmp, "warm.avi")
        with open(warm, "wb") as f:
            f.write(m.avi.mux(*(p[:16] for p in pics), pcm_in[:AVI_RATE],
                              fps=FPS, sample_rate=AVI_RATE))
        log(f"ingest input: {n_frames} frames {AVI_W}x{AVI_H} I420 ({n_unique}"
            f" seeded pictures tiled) + {len(pcm_in)} samples of 44,100 Hz "
            f"mono s16, muxed by avi.mux: {size} bytes; "
            f"{time.perf_counter() - t12:.1f} s")
        argv = ["-i", src, "-f", "amv", "-r", str(FPS), "-s", f"{W}x{H}",
                "-ac", "1", "-ar", str(RATE), dst, "--device", dev.type]
        m.cli.main(["-i", warm, *argv[2:-3], os.path.join(tmp, "w.amv"),
                    "--device", dev.type])                         # warm-up
        sync()
        reset_launches(m)
        wall, walls = timed_cli(m, argv)
        paths["ingest"] = launches(m)
        assert all(paths["ingest"][k] > 0 for k in ("V", "E", "E count",
                                                    "Q")), paths
        with open(dst, "rb") as f:
            out = m.riff.demux(f.read())
        log(f"{card}: ingest, cli.main -i in.avi -f amv -r 16 -s 160x120 -ac "
            f"1 -ar 22050 x3, {n_frames} frames in "
            f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s "
            f"= {n_frames / wall:.1f} frames/s; launches {paths['ingest']}")

        # the CPU route's planes and PCM, and the card's, by the same calls
        vst, ast = m.avi.read(src)
        cpu = torch.device("cpu")

        def route(d):
            planes = m.scale.resize_yuv420(
                *m.avi.extract_yuv420(vst, device=d), H, W)
            pcm = m.resample.resample_pcm(m.avi.extract_pcm(ast, device=d),
                                          AVI_RATE, RATE, device=d)
            return [t.cpu() for t in (*planes, pcm)]

        want = route(cpu)
        assert all(torch.equal(a, b) for a, b in zip(route(dev), want)), \
            "the card's planes or PCM differ from the CPU route's"
        y, cb, cr, pcm = (t.numpy() for t in want)
        uniq = [m.native.ref_encode_frame(y[i], cb[i], cr[i], QSCALE)
                for i in range(min(n_unique, n_frames))]
        assert all(np.array_equal(p[i], p[i % n_unique]) for p in (y, cb, cr)
                   for i in range(n_frames))
        assert out.video_chunks == [uniq[i % n_unique]
                                    for i in range(n_frames)], \
            "ingest video differs from the C encoder"
        frame_size = m.encode.av_rescale_near(RATE, 1, FPS)
        t0 = time.perf_counter()
        assert out.audio_chunks == m.ref_adpcm.encode(pcm, frame_size, RATE),\
            "ingest audio differs from the ADPCM oracle"
        log(f"ingest: video byte-identical to the C encoder of the CPU "
            f"route's scaled planes ({n_unique} distinct), {len(pcm)} "
            f"resampled samples and {len(out.audio_chunks)} audio chunks "
            f"equal to the oracle's (which took "
            f"{time.perf_counter() - t0:.1f} s); the card's planes and PCM "
            "equal the CPU route's")

        # the stages one by one, each with a synchronize after it
        split = {}
        fb = AVI_W * AVI_H * 3 // 2
        host = torch.empty((n_frames, fb), dtype=torch.uint8, pin_memory=cuda)

        def read():
            with open(src, "rb") as f:
                return f.read()

        data = staged(split, "read", read)
        vst, ast = staged(split, "demux", lambda: m.avi.demux(data))

        def stage_host():
            hv = host.numpy()
            for i, c in enumerate(vst.chunks):
                hv[i] = np.frombuffer(c, np.uint8, fb)

        staged(split, "host staging (pinned)", stage_host)
        buf = staged(split, "host->device", lambda: host.to(
            dev, non_blocking=True))
        planes = staged(split, "device unpack", lambda: [
            t.clone() for t in m.avi._unpack("i420", buf, vst, None)])
        scaled = staged(split, "device scale", lambda: m.scale.resize_yuv420(
            *planes, H, W))
        pcm_d = staged(split, "audio extract", lambda: m.avi.extract_pcm(
            ast, device=dev))
        pcm_r = staged(split, "device resample", lambda: (
            m.resample.resample_pcm(pcm_d, AVI_RATE, RATE, device=dev)))
        lv = staged(split, "device V", lambda: m.V.encode_planes(*scaled,
                                                                 QSCALE))
        bits = staged(split, "device E count", lambda: m.E.count_bits(lv))
        words, bits, _ = staged(split, "device E", lambda: m.E.encode_levels(
            lv, m.amv_video.used_words(bits)))
        w_np, b_np = staged(split, "device->host words", lambda: (
            words.cpu().numpy(), bits.cpu().numpy()))
        vch = staged(split, "escape", lambda: m.native.escape_frames(w_np,
                                                                     b_np))
        pcm_h = staged(split, "device->host pcm", lambda: pcm_r.cpu().numpy())
        lay = staged(split, "audio layout", lambda: (
            m.amv_audio.stream_layout(pcm_h, frame_size, RATE)))
        tq = staged(split, "audio to device", lambda: [
            torch.from_numpy(a[None]).to(dev) for a in lay[2:]])
        staged(split, "device Q", lambda: m.adpcm.encode_streams(
            *tq, torch.zeros(1, dtype=torch.int32, device=dev)))
        achunks = m.amv_audio.encode_stream(pcm_h, frame_size, RATE,
                                            device=dev)
        staged(split, "mux", lambda: m.riff.mux(
            vch, achunks, width=W, height=H, fps=FPS, sample_rate=RATE))
        assert vch == out.video_chunks and achunks == out.audio_chunks
        log_split(f"{card}: ingest", split,
                  f"; {n_frames} frames, all at once (the CLI unpacks and "
                  "scales in batches of 1,024)")
        del host, buf, planes, scaled, lv, words, data, vst, ast

    # each raw AVI format on the card against the CPU route
    rng = np.random.default_rng(12)
    fmt_ms = {}
    for codec, bits, w, pal, masks in INGEST_FORMATS:
        kw = dict(codec=codec, bits=bits, width=w, height=AVI_H)
        if pal:
            kw["palette"] = rng.integers(0, 256, (256, 4), dtype=np.uint8)
        if masks:
            kw["bitmasks"] = masks
        fb = m.avi._layout(m.avi.AviStream("video", **kw))[1]
        raw = rng.integers(0, 256, (n_fmt, fb), dtype=np.uint8)
        st = m.avi.AviStream("video", chunks=[r.tobytes() for r in raw], **kw)
        got = staged(fmt_ms, f"{codec.decode().strip() or 'BI_RGB'}/{bits}"
                     f"{'/565' if masks else ''}{'/pal' if pal else ''}"
                     f"/{w}", lambda: m.avi.extract_yuv420(st, device=dev))
        want = m.avi.extract_yuv420(st, device=cpu)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), codec
    log(f"{card}: {n_fmt} frames of each raw AVI format unpacked on the card"
        " equal to the CPU route; ms (host clock, one call after a "
        "synchronize): " + ", ".join(f"{k} {v * 1e3:.2f}"
                                     for k, v in fmt_ms.items()))

    # each -sws_flags value on the I420 file's first frames
    first = [torch.from_numpy(np.ascontiguousarray(p[:n_fmt])) for p in pics]
    sws_ms = {}
    for filt in SWS_FLAGS:
        on = [t.to(dev) for t in first]
        got = staged(sws_ms, filt, lambda: m.scale.resize_yuv420(
            *on, H, W, filt=filt))
        want = m.scale.resize_yuv420(*first, H, W, filt=filt)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), filt
    log(f"{card}: each -sws_flags value, {n_fmt} frames {AVI_W}x{AVI_H} -> "
        f"{W}x{H} on the card equal to the CPU route; ms (host clock): " +
        ", ".join(f"{k} {v * 1e3:.2f}" for k, v in sws_ms.items()))

    # each WAVE format: the card against the CPU route and the oracles
    a0 = m.adpcm.DECODE_LAUNCHES
    rates = {}
    for name, (fmt, bits, ba, data) in wav_streams(wav_s, rng).items():
        def dec(d=dev):
            return m.wav_audio.decode_pcm_bytes(data, fmt, bits, 2, ba,
                                                device=d)

        a1 = m.adpcm.DECODE_LAUNCHES
        m.adpcm.MS_LAUNCHES = 0
        dec()
        sync()
        launched = m.adpcm.DECODE_LAUNCHES - a1
        assert (launched > 0) == (name == "ima"), (name, launched)
        assert (m.adpcm.MS_LAUNCHES > 0) == (name == "ms"), name
        if name == "ms":
            paths["wav ms"] = {"M": m.adpcm.MS_LAUNCHES}
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = dec()
            sync()
            ts.append(time.perf_counter() - t0)
        want = dec(cpu)
        assert torch.equal(got.cpu(), want), name
        head = wav_oracle(m, fmt, bits, ba, data, 64)
        assert np.array_equal(want[:len(head)].numpy(), head), name
        t = statistics.median(ts)
        rates[name] = (want.numel() / t / 1e6, t)
        if name == "ms":
            lanes = m.wav_audio._lanes(data, 2, ba, 14, m.wav_audio._ms_lanes)
            tl = [torch.from_numpy(a).to(dev) for a in lanes[1]]
            b_ms, n_ms = tl[0].shape
            check("M", lambda: (m.adpcm.decode_ms_nibbles(*tl),),
                  lambda: (m.adpcm.decode_ms_nibbles_plain(*tl),),
                  f"{b_ms} lanes of {n_ms} samples (MS-ADPCM, {wav_s:.0f} s "
                  f"of 44,100 Hz stereo at block_align {ba})",
                  3 * b_ms * n_ms + 20 * b_ms, OPS_MS * b_ms * n_ms)
    paths["wav ima"] = {"A": m.adpcm.DECODE_LAUNCHES - a0}
    log(f"{card}: WAVE decodes of {wav_s:.0f} s of 44,100 Hz stereo, on the "
        "card equal to the CPU route and (first 64 blocks) the scalar "
        "oracles; Msamples/s (both channels, median of 3, host clock): " +
        ", ".join(f"{k} {r:.1f} ({t * 1e3:.1f} ms)"
                  for k, (r, t) in rates.items()) +
        f"; kernel A launched {paths['wav ima']['A']} times for IMA-WAV, "
        f"kernel M {paths['wav ms']['M']} times for MS-ADPCM")
    log(f"phase 12 took {time.perf_counter() - t12:.1f} s")

def trellis_phase(m, dev, paths, card, check, kern, pics, pcm, tmp,
                  n_oracle=N_ORACLE) -> None:
    """Phase 13: the 300 s stream of phase 7 through cli.main with -trellis
    (x3): kernel L against its plain version on the card from the file's
    chunk starts, the chain at its fixed point, the rounds from kernel Q's
    guesses, the first n_oracle chunks against the numpy oracle, and every
    chunk decoded by the C ADPCM decoder."""
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t13 = time.perf_counter()
    n, h, w = pics[0].shape
    yin, win, dst = (os.path.join(tmp, f) for f in ("t.yuv", "t.wav",
                                                     "t.amv"))
    np.concatenate([p.reshape(n, -1) for p in pics], axis=1).tofile(yin)
    m.wav.write_pcm(win, pcm, RATE)
    frame_size = m.encode.av_rescale_near(RATE, 1, FPS)
    m.amv_audio.encode_stream(pcm[:RATE], frame_size, RATE, trellis=True,
                              device=dev)                       # warm-up
    sync()
    reset_launches(m)
    wall, walls = timed_cli(m, [
        "-i", yin, "-i", win, "-f", "amv", "-s", f"{w}x{h}", "-r", str(FPS),
        "-ar", str(RATE), "-trellis", dst, "--device", dev.type])
    paths["trellis"] = launches(m)
    assert all(paths["trellis"][k] > 0 for k in ("V", "E", "Q", "L")), paths
    with open(dst, "rb") as f:
        out = m.riff.demux(f.read())
    log(f"{card}: trellis, cli.main -i .yuv -i .wav ... -trellis x3, {n} "
        f"frames + {len(pcm)} samples in "
        f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s "
        f"= {len(pcm) / wall / 1e6:.3f} Msamples/s; launches "
        f"{paths['trellis']}")

    ns, starts, padded, reset = m.amv_audio.stream_layout(pcm, frame_size,
                                                          RATE)
    x = torch.from_numpy(padded).to(dev)
    st = torch.from_numpy(starts).to(dev)
    pairs = torch.tensor(ns, dtype=torch.int32, device=dev)
    step = torch.tensor([int.from_bytes(c[2:4], "little")
                         for c in out.audio_chunks], dtype=torch.int32,
                        device=dev)
    pred0 = x[st].to(torch.int32)
    n_samp = len(padded)

    def run(fn):
        buf = torch.zeros(n_samp // 2, dtype=torch.uint8, device=dev)
        return buf, fn(x, st, pairs, step, pred0, buf)

    buf, final = check(
        "L", lambda: run(m.L.trellis_chunks),
        lambda: run(m.L.trellis_chunks_plain),
        f"{len(ns)} chunks of {2 * ns[0]} samples from the file's starts",
        n_samp * (89 + 2.5), n_samp * EDGES * OPS_EDGE)
    assert torch.equal(step[1:], final[:-1]), "the chain is off its fixed point"
    got = buf.cpu().numpy()
    assert all(got[s // 2: s // 2 + k].tobytes() == c[8:] for s, k, c in
               zip(starts.tolist(), ns, out.audio_chunks)), \
        "kernel L's bytes from the file's starts differ from the file's"
    # the path's rounds: round 1 from kernel Q's step indices
    _, sidx_even = m.adpcm.encode_streams(
        x[None], torch.from_numpy(reset[None]).to(dev),
        torch.zeros(1, dtype=torch.int32, device=dev))
    guess = sidx_even[0, st // 2].to(torch.int32)
    sizes, launch = [], m.L.trellis_chunks

    def counted(x, starts, *a):            # the chunks of each round
        sizes.append(starts.shape[0])
        return launch(x, starts, *a)

    m.L.trellis_chunks = counted
    try:
        _, step2, _, rounds = m.L.encode_chain(x, st, pairs, 0, guess,
                                               rounds=True)
    finally:
        m.L.trellis_chunks = launch
    assert torch.equal(step2, step) and len(sizes) == rounds
    chain_ms = cuda_ms(lambda: m.L.encode_chain(x, st, pairs, 0, guess), 3)[0]
    kern["L"].update(rounds=rounds, chain_ms=chain_ms,
                     chunks_a_round=sizes)
    log(f"L: the chain from kernel Q's guesses took {rounds} rounds "
        f"(chunks a round {sizes}) "
        f"({int((guess[1:] != step[1:]).sum())} of {len(ns) - 1} guesses "
        f"wrong), {paths['trellis']['L'] // 3} launches a pass; "
        f"encode_chain {chain_ms:.3f} ms (median of 3, CUDA events), "
        f"kernel L {kern['L']['ms']:.3f} ms a launch over all chunks; its "
        f"own candidates ({EDGES_EVALUATED} of the {EDGES} in-edges a "
        f"sample) at {OPS_EDGE} operations each take "
        f"{bound(0, n_samp * EDGES_EVALUATED * OPS_EDGE)[0]:.4f} ms")
    t0 = time.perf_counter()
    fin = final.cpu().numpy()
    for k in range(min(n_oracle, len(ns))):
        s, nk = int(starts[k]), ns[k]
        nib, f_k = m.ref_trellis.trellis_encode_fast(
            padded[s:s + 2 * nk], int(step[k]), int(padded[s]))
        assert ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes() \
            == out.audio_chunks[k][8:] and f_k == fin[k], f"chunk {k}"
    t_oracle = time.perf_counter() - t0
    greedy = m.amv_audio.encode_stream(pcm, frame_size, RATE, device=dev)
    snr = []
    for chunks in (out.audio_chunks, greedy):
        dec = np.concatenate([m.native.ref_adpcm_decode(
            c[8:], int.from_bytes(c[0:2], "little", signed=True),
            min(int.from_bytes(c[2:4], "little"), 88)) for c in chunks])
        assert len(dec) == n_samp
        err = np.sum((dec.astype(np.int64) - padded) ** 2)
        snr.append(10 * np.log10(np.sum(padded.astype(np.int64) ** 2) /
                                 max(err, 1)))
    log(f"trellis: bytes of kernel L from the file's starts equal the "
        f"file's; the chain at its fixed point; the first {n_oracle} "
        f"chunks equal the numpy oracle (which took {t_oracle:.1f} s); "
        f"every chunk decodes (C ADPCM decoder): SNR {snr[0]:.3f} dB, the "
        f"greedy encoder's {snr[1]:.3f} dB")
    log(f"phase 13 took {time.perf_counter() - t13:.1f} s")


def mjpeg_phase(m, dev, paths, card, check, amv_data, tmp,
                n_frames=N_FRAMES, n_unique=N_UNIQUE, n_fmt=N_FMT):
    """Phase 14: a camera's MJPG AVI (the port's own 4:2:2 encode with a
    restart interval of 5 MCUs, n_unique seeded 320x240 pictures tiled to
    n_frames, 44,100 Hz PCM) through the canonical `-f amv -r 16 -s
    160x120 -ac 1 -ar 22050 -trellis` (cli.main x2): F launched by the
    encode, I, V, E, Q and L by the conversion, every frame through the
    host C scan decoder; the card's planes equal the CPU route's, the
    video the C encoder's of them; the stages one by one; a 4:2:0
    `-vcodec mjpeg` file of the port decoded through kernel D; 4:2:0,
    4:4:4 and gray with restart intervals 0 and 1, card against CPU.
    Returns the pictures (y, cb, cr), for phase 18."""
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cpu = torch.device("cpu")
    t14 = time.perf_counter()
    pics = pictures(m, n_unique, AVI_H, AVI_W, seed=14)
    c422 = [np.repeat(c, 2, axis=1) for c in pics[1:]]
    f0 = m.fdct.LAUNCHES
    pays = m.mjpeg.encode_mjpeg_frames(pics[0], *c422, QSCALE, "422", 5,
                                       device=dev)
    sync()
    paths["mjpeg encode"] = {"F": m.fdct.LAUNCHES - f0}
    assert paths["mjpeg encode"]["F"] > 0, paths
    assert pays[:8] == m.mjpeg.encode_mjpeg_frames(
        pics[0][:8], *(c[:8] for c in c422), QSCALE, "422", 5, device=cpu)
    mb_w, mb_h = AVI_W // 16, AVI_H // 8
    blocks = m.mjpeg.extract_blocks_topdown(
        *(torch.from_numpy(p).to(dev) for p in (pics[0], *c422)), "422",
        mb_w, mb_h).contiguous()
    qmat = m.jpeg_tables.encoder_qmat(QSCALE)
    check("F mjpeg", lambda: (m.fdct.fdct_quantize(blocks, qmat),),
          lambda: (m.fdct.fdct_quantize_plain(
              blocks.reshape(-1, 64), qmat).reshape(*blocks.shape[:-2], 64),),
          f"{blocks.numel() // 64} blocks of {n_unique} 4:2:2 frames",
          blocks.numel() * 3, blocks.numel() // 64 * OPS_FDCT)
    del blocks
    tiled = [pays[i % n_unique] for i in range(n_frames)]
    pcm_in = m.fixtures.audiogen(n_frames / FPS, AVI_RATE, seed=14)
    src, dst = os.path.join(tmp, "cam.avi"), os.path.join(tmp, "cam.amv")
    warm = os.path.join(tmp, "cam_warm.avi")
    for path, k, a in ((src, n_frames, pcm_in), (warm, 16, pcm_in[:AVI_RATE])):
        geom = np.broadcast_to(np.uint8(0), (k, AVI_H, AVI_W))
        with open(path, "wb") as f:
            f.write(m.avi.mux(geom, geom, geom, a, fps=FPS,
                              sample_rate=AVI_RATE, video_chunks=tiled[:k]))
    log(f"mjpeg input: {n_frames} frames {AVI_W}x{AVI_H} MJPG 4:2:2, "
        f"restart interval 5 ({n_unique} pictures encoded on the card by "
        f"encode_mjpeg_frames, tiled; F launched "
        f"{paths['mjpeg encode']['F']} times) + {len(pcm_in)} samples of "
        f"44,100 Hz PCM: {os.path.getsize(src)} bytes; "
        f"{time.perf_counter() - t14:.1f} s")
    argv = ["-f", "amv", "-r", str(FPS), "-s", f"{W}x{H}", "-ac", "1",
            "-ar", str(RATE), "-trellis"]
    m.cli.main(["-i", warm, *argv, os.path.join(tmp, "w.amv"), "--device",
                dev.type])                                      # warm-up
    sync()
    reset_launches(m)
    h0 = m.mjpeg.HOST_FRAMES
    wall, walls = timed_cli(m, ["-i", src, *argv, dst, "--device",
                                dev.type], runs=2)
    paths["mjpeg ingest"] = launches(m)
    host = m.mjpeg.HOST_FRAMES - h0
    assert all(paths["mjpeg ingest"][k] > 0 for k in "IVEQL") and \
        paths["mjpeg ingest"]["D"] == 0 and host == 2 * n_frames, \
        (paths, host)
    with open(dst, "rb") as f:
        out = m.riff.demux(f.read())
    log(f"{card}: mjpeg ingest, cli.main -i cam.avi -f amv -r 16 -s 160x120"
        f" -ac 1 -ar 22050 -trellis x2, {n_frames} frames in "
        f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s = "
        f"{n_frames / wall:.1f} frames/s; {host} frames through the host C "
        f"scan decoder; launches {paths['mjpeg ingest']}")

    # the card's planes against the CPU route's, and the video against the
    # C encoder of them
    vst, ast = m.avi.read(src)
    head = m.avi.AviStream("video", codec=vst.codec, width=vst.width,
                           height=vst.height, chunks=vst.chunks[:n_unique])
    planes = {}
    for d in (dev, cpu):
        dec = m.avi.extract_yuv420(head, device=d)
        planes[d.type] = [t.cpu() for t in (*dec, *m.scale.resize_yuv420(
            *dec, H, W))]
    assert all(torch.equal(a, b) for a, b in zip(planes[dev.type],
                                                 planes["cpu"])), \
        "the card's MJPEG planes differ from the CPU route's"
    y, cb, cr = (t.numpy() for t in planes["cpu"][3:])
    uniq = [m.native.ref_encode_frame(y[i], cb[i], cr[i], QSCALE)
            for i in range(n_unique)]
    assert out.video_chunks == [uniq[i % n_unique] for i in range(n_frames)],\
        "mjpeg ingest video differs from the C encoder"
    pcm_r = m.resample.resample_pcm(m.avi.extract_pcm(ast, device=dev),
                                    AVI_RATE, RATE, device=dev).cpu().numpy()
    frame_size = m.encode.av_rescale_near(RATE, 1, FPS)
    assert out.audio_chunks == m.amv_audio.encode_stream(
        pcm_r, frame_size, RATE, trellis=True, device=dev)
    ns, starts, padded, _ = m.amv_audio.stream_layout(pcm_r, frame_size, RATE)
    for k in range(8):
        s, nk = int(starts[k]), ns[k]
        nib, _ = m.ref_trellis.trellis_encode_fast(
            padded[s:s + 2 * nk], int.from_bytes(out.audio_chunks[k][2:4],
                                                 "little"), int(padded[s]))
        assert ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes() \
            == out.audio_chunks[k][8:], f"audio chunk {k}"
    log(f"mjpeg ingest: the card's decoded and scaled planes of the first "
        f"{n_unique} frames equal the CPU route's; video byte-identical to "
        "the C encoder of them; audio the trellis encode of the resampled "
        "PCM, its first 8 chunks equal to the numpy oracle")

    # the stages one by one, all frames at once, a synchronize after each
    split = {}

    def read():
        with open(src, "rb") as f:
            return f.read()

    data = staged(split, "read", read)
    vst, ast = staged(split, "demux", lambda: m.avi.demux(data))
    frames = staged(split, "parse headers", lambda: [
        m.jpeg_parse.parse_jpeg(c) for c in vst.chunks])
    levels = staged(split, "scan decode (host C) + upload",
                    lambda: m.mjpeg._scan_levels(frames, mb_w * mb_h, 4,
                                                 "422", dev))
    qm = np.stack([frames[0].quant[tq] for (_, _, _, tq) in
                   frames[0].mcu_blocks()])
    raster = staged(split, "device dequant + DC", lambda: (
        m.mjpeg.dequantize(levels, qm, "422", 5)))
    del levels
    pix = staged(split, "device I (idct_put)",
                 lambda: m.idct.idct_put(raster))
    dec = staged(split, "device assembly", lambda: [t.clone() for t in (
        m.mjpeg.assemble(pix, "422", mb_w, mb_h, AVI_W, AVI_H))])
    p420 = staged(split, "device to 4:2:0", lambda: (
        m.avi.mjpeg_to_yuv420(*dec, AVI_W, AVI_H)))
    scaled = staged(split, "device scale", lambda: m.scale.resize_yuv420(
        *p420, H, W))
    lv = staged(split, "device V", lambda: m.V.encode_planes(*scaled,
                                                             QSCALE))
    bits = staged(split, "device E count", lambda: m.E.count_bits(lv))
    words, bits, _ = staged(split, "device E", lambda: m.E.encode_levels(
        lv, m.amv_video.used_words(bits)))
    w_np, b_np = staged(split, "device->host words", lambda: (
        words.cpu().numpy(), bits.cpu().numpy()))
    vch = staged(split, "escape", lambda: m.native.escape_frames(w_np, b_np))
    pcm_d = staged(split, "audio extract", lambda: m.avi.extract_pcm(
        ast, device=dev))
    pcm_h = staged(split, "device resample + to host", lambda: (
        m.resample.resample_pcm(pcm_d, AVI_RATE, RATE,
                                device=dev).cpu().numpy()))
    achunks = staged(split, "audio trellis (Q, L)", lambda: (
        m.amv_audio.encode_stream(pcm_h, frame_size, RATE, trellis=True,
                                  device=dev)))
    staged(split, "mux", lambda: m.riff.mux(
        vch, achunks, width=W, height=H, fps=FPS, sample_rate=RATE))
    assert vch == out.video_chunks and achunks == out.audio_chunks
    log_split(f"{card}: mjpeg ingest", split,
              f"; {n_frames} frames, all at once (the CLI decodes, "
              "transforms and scales in batches of 1,024)")
    batch = min(n_frames, m.avi.BATCH_FRAMES)
    check("I mjpeg", lambda: (m.idct.idct_put(raster[:batch]),),
          lambda: (m.idct.idct_put_plain(raster[:batch].reshape(-1, 64))
                   .reshape(raster[:batch].shape),),
          f"{raster[:batch].numel() // 64} blocks ({batch} frames of "
          "4:2:2, the CLI's batch)", raster[:batch].numel() * 3,
          raster[:batch].numel() // 64 * OPS_IDCT)
    del raster, pix, dec, p420, scaled, lv, words, data, frames

    # a 4:2:0 -vcodec mjpeg file written by the port decodes through D
    amv_src, mj = os.path.join(tmp, "c.amv"), os.path.join(tmp, "rt.avi")
    with open(amv_src, "wb") as f:
        f.write(amv_data)
    reset_launches(m)
    assert m.cli.main(["-i", amv_src, "-vcodec", "mjpeg", "--max-frames",
                       str(n_fmt), mj, "--device", dev.type]) == 0
    paths["vcodec mjpeg"] = launches(m)
    assert all(paths["vcodec mjpeg"][k] > 0 for k in "DUVE") and \
        paths["vcodec mjpeg"]["F"] == 0, paths
    chunks = m.avi.read(mj)[0].chunks
    d0, h0 = m.D.LAUNCHES, m.mjpeg.HOST_FRAMES
    got = m.mjpeg.decode_mjpeg_frames(chunks, device=dev)
    assert m.D.LAUNCHES > d0 and m.mjpeg.HOST_FRAMES == h0
    want = m.mjpeg.decode_mjpeg_frames(chunks, device=cpu)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    log(f"vcodec mjpeg: cli.main -i .amv -vcodec mjpeg, {n_fmt} frames "
        f"(launches {paths['vcodec mjpeg']}); its 4:2:0 frames decode "
        "through kernel D (no host frame) to the CPU route's planes")

    # 4:2:0, 4:4:4 and gray with restart intervals 0 and 1, card vs CPU
    y = pics[0][:n_fmt]
    chroma = {"420": [c[:n_fmt] for c in pics[1:]],
              "444": [np.repeat(np.repeat(c[:n_fmt], 2, 1), 2, 2)
                      for c in pics[1:]], "gray": [None, None]}
    ms = {}
    for layout, ch in chroma.items():
        for ri in (0, 1):
            key = f"{layout}/{ri}"
            pay = staged(ms, f"encode {key}", lambda: (
                m.mjpeg.encode_mjpeg_frames(y, *ch, QSCALE, layout, ri,
                                            device=dev)))
            assert pay == m.mjpeg.encode_mjpeg_frames(
                y, *ch, QSCALE, layout, ri, device=cpu), key
            got = staged(ms, f"decode {key}", lambda: (
                m.mjpeg.decode_mjpeg_frames(pay, device=dev)))
            want = m.mjpeg.decode_mjpeg_frames(pay, device=cpu)
            assert all((a is None and b is None) or torch.equal(a.cpu(), b)
                       for a, b in zip(got, want)), key
    log(f"{card}: {n_fmt} frames {AVI_W}x{AVI_H} of 4:2:0, 4:4:4 and gray "
        "with restart intervals 0 and 1: bytes and planes on the card "
        "equal the CPU route's; ms (host clock, one call): " +
        ", ".join(f"{k} {v * 1e3:.1f}" for k, v in ms.items()))
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    return pics


def _redefined_tables_frame(m):
    """An 8x8 gray progressive frame whose two AC scans use different
    Huffman tables under the same id (1, 0), as libjpeg/mozjpeg's
    optimized output redefines them between scans; its coefficients are
    DC 5, AC1 3 and AC6 -2."""
    T, R = m.jpeg_tables, m.ref_jpeg

    def table(lens_vals):
        bits, vals = np.zeros(17, np.int32), [v for _, v in lens_vals]
        for n, _ in lens_vals:
            bits[n] += 1
        return bits, np.array(vals, np.int32)

    def dht(tc, bits, vals):
        body = bytes([tc << 4]) + bytes(bits[1:].astype(np.uint8)) + \
            bytes(vals.astype(np.uint8))
        return b"\xFF\xC4" + (len(body) + 2).to_bytes(2, "big") + body

    def scan(ss, se, puts):
        bw = R.BitWriter()
        for n, v in puts:
            bw.put_bits(n, v)
        bw.put_bits((-bw.bit_count()) & 7, 0xFF)
        return b"\xFF\xDA\x00\x08\x01\x01\x00" + bytes([ss, se, 0]) + \
            R.escape_ff(bw.flush())

    def code(t, sym):
        sizes, codes = T.build_huffman_codes(*t)
        return int(sizes[sym]), int(codes[sym])

    dc = table([(3, k) for k in range(8)])
    ta = table([(2, 0x02), (2, 0x00)])
    tb = table([(1, 0x00), (2, 0x02)])
    return (b"\xFF\xD8\xFF\xDB\x00\x43\x00" + bytes([1] * 64) +
            dht(0, *dc) + dht(1, *ta) +
            b"\xFF\xC2\x00\x0B\x08\x00\x08\x00\x08\x01\x01\x11\x00" +
            scan(0, 0, [code(dc, 3), (3, 0b101)]) +
            scan(1, 5, [code(ta, 2), (2, 0b11), code(ta, 0)]) +
            dht(1, *tb) + scan(6, 63, [code(tb, 2), (2, 0b01), code(tb, 0)])
            + b"\xFF\xD9")


def sof2_sof3_phase(m, dev, paths, card, check, tmp, pics,
                    n_frames=N_FRAMES, n_unique=PROG_UNIQUE,
                    workers=4) -> None:
    """Phase 18: progressive (SOF2) and lossless (SOF3) MJPEG input.
    n_unique of phase 14's 320x240 pictures, encoded progressive (the
    coefficients of the port's baseline encode at qscale 2, DC made
    absolute; Al 1 and refinement scans) and lossless (4:2:0, predictor 1)
    by the port's encoders in a pool of worker processes, each set tiled
    to n_frames in a 5-minute MJPG AVI with 44,100 Hz PCM, through the
    canonical `-f amv -r 16 -s 160x120 -ac 1 -ar 22050` (cli.main x3):
    I, V, E, Q launched for SOF2, V, E, Q (not I) for SOF3; the stages one
    by one; the card's planes of the distinct frames equal the CPU
    route's, the progressive ones the baseline decode of the same
    coefficients, the lossless ones the pictures and the plain Python
    walk's (in the workers); the audio the CPU route's; 8 x n_unique
    check frames at 96x64, card = CPU (predictors 1-7, RGB plain, RCT and
    Pegasus, point transform 2, restart interval 1, progressive Al 0 and
    2, per-scan table redefinition); I against its plain version at this
    path's shape."""
    import torch
    t18 = time.perf_counter()
    cpu = torch.device("cpu")
    y, cb, cr = (np.ascontiguousarray(p[:n_unique]) for p in pics)
    mb_w, mb_h = AVI_W // 16, AVI_H // 16
    zz = torch.as_tensor(m.jpeg_tables.ZIGZAG, device=dev).long()

    def levels(planes, w, h):
        """Zigzag levels of the port's baseline encode (qscale 2)."""
        blocks = m.mjpeg.extract_blocks_topdown(
            *(torch.from_numpy(p).to(dev) for p in planes), "420",
            (w + 15) // 16, (h + 15) // 16)
        return m.fdct.fdct_quantize(blocks.contiguous(), m.jpeg_tables.
                                    encoder_qmat(QSCALE))[..., zz].cpu().numpy()

    lv = levels((y, cb, cr), AVI_W, AVI_H)
    prog_lv = lv.copy()
    prog_lv[..., 0] -= 128          # the progressive DC is absolute
    # the 64 check frames, at 96x64
    cw, ch = 96, 64
    cy, ccb, ccr = y[:, :ch, :cw], cb[:, :ch // 2, :cw // 2], \
        cr[:, :ch // 2, :cw // 2]
    clv = levels((cy, ccb, ccr), cw, ch)
    clv[..., 0] -= 128
    enc_p, enc_l = m.jpeg_progressive.encode_progressive, \
        m.jpeg_lossless.encode_lossless
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        jobs = {"prog": [pool.submit(enc_p, prog_lv[i], (AVI_W, AVI_H))
                         for i in range(n_unique)],
                "ll": [pool.submit(enc_l, [y[i], cb[i], cr[i]], 1)
                       for i in range(n_unique)]}
        k = range(n_unique)
        checks = {
            "predictors 1-7, pt 2": [pool.submit(
                enc_l, [cy[i], ccb[i], ccr[i]], 1 + i % 7,
                2 if i == 7 else 0) for i in k],
            "restart interval 1": [pool.submit(
                enc_l, [cy[i], ccb[i], ccr[i]], 1 + i % 7, 0, False, False,
                False, 8, 1) for i in k],
            **{f"rgb {x}": [pool.submit(
                enc_l, [cy[i], cy[i][::-1].copy(), cy[i][:, ::-1].copy()],
                1 + i % 7, 0, True, x == "pegasus", x == "rct") for i in k]
               for x in ("plain", "rct", "pegasus")},
            **{f"progressive al {a}": [pool.submit(enc_p, clv[i], (cw, ch),
                                                   "420", a, a) for i in k]
               for a in (0, 2)}}
        prog = [f.result() for f in jobs["prog"]]
        ll = [f.result() for f in jobs["ll"]]
        plain = [pool.submit(m.jpeg_lossless.decode_lossless, p, False)
                 for p in ll]
        checks = {key: [f.result() for f in fs] for key, fs in checks.items()}
        checks["per-scan tables"] = [_redefined_tables_frame(m)] * n_unique
        plain = [f.result() for f in plain]
    finally:
        pool.shutdown()
    base = [m.mjpeg.jpeg_header_with_tables(
        AVI_W, AVI_H, m.jpeg_tables.encoder_quant_matrix(QSCALE)[
            m.jpeg_tables.ZIGZAG]) + s + b"\xFF\xD9"
        for s in m.native.pack_scans_generic(lv, m.mjpeg.COMP_OF_BLOCK["420"])]
    pcm_in = m.fixtures.audiogen(n_frames / FPS, AVI_RATE, seed=18)
    files = {}
    for name, frames in (("prog", prog), ("ll", ll)):
        tiled = [frames[i % n_unique] for i in range(n_frames)]
        files[name] = os.path.join(tmp, f"{name}.avi")
        for path, n, a in ((files[name], n_frames, pcm_in),
                           (os.path.join(tmp, f"{name}_warm.avi"), 16,
                            pcm_in[:AVI_RATE])):
            geom = np.broadcast_to(np.uint8(0), (n, AVI_H, AVI_W))
            with open(path, "wb") as f:
                f.write(m.avi.mux(geom, geom, geom, a, fps=FPS,
                                  sample_rate=AVI_RATE,
                                  video_chunks=tiled[:n]))
    log(f"sof2/sof3 input: {n_unique} of phase 14's {AVI_W}x{AVI_H} "
        f"pictures encoded by the port in {workers} worker processes, "
        f"progressive (Al 1 + refinement, {min(map(len, prog))}-"
        f"{max(map(len, prog))} bytes) and lossless (4:2:0, predictor 1, "
        f"{min(map(len, ll))}-{max(map(len, ll))} bytes), each tiled to "
        f"{n_frames} frames with {len(pcm_in)} samples of 44,100 Hz PCM: "
        f"prog.avi {os.path.getsize(files['prog'])} bytes, ll.avi "
        f"{os.path.getsize(files['ll'])} bytes; "
        f"{time.perf_counter() - t18:.1f} s")

    argv = ["-f", "amv", "-r", str(FPS), "-s", f"{W}x{H}", "-ac", "1",
            "-ar", str(RATE)]
    frame_size = m.encode.av_rescale_near(RATE, 1, FPS)
    audio = None
    for name, want_kernels in (("prog", "IVEQ"), ("ll", "VEQ")):
        src, dst = files[name], os.path.join(tmp, f"{name}.amv")
        m.cli.main(["-i", os.path.join(tmp, f"{name}_warm.avi"), *argv,
                    os.path.join(tmp, "w.amv"), "--device", dev.type])
        torch.cuda.synchronize()
        reset_launches(m)
        wall, walls = timed_cli(m, ["-i", src, *argv, dst, "--device",
                                    dev.type])
        key = {"prog": "progressive ingest", "ll": "lossless ingest"}[name]
        paths[key] = launches(m)
        assert all(paths[key][k] > 0 for k in want_kernels) and \
            (name == "prog" or paths[key]["I"] == 0) and \
            paths[key]["D"] == 0, paths[key]
        log(f"{card}: {key}, cli.main -i {name}.avi -f amv -r 16 -s 160x120 "
            f"-ac 1 -ar 22050 x3, {n_frames} frames in "
            f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s"
            f" = {n_frames / wall:.1f} frames/s; launches {paths[key]}")
        with open(dst, "rb") as f:
            out = m.riff.demux(f.read())

        # the distinct frames: the card's planes against the CPU route's,
        # and the video against the C encoder of them
        vst, ast = m.avi.read(src)
        head = m.avi.AviStream("video", codec=vst.codec, width=vst.width,
                               height=vst.height,
                               chunks=vst.chunks[:n_unique])
        planes = {}
        for d in (dev, cpu):
            dec = m.avi.extract_yuv420(head, device=d)
            planes[d.type] = [t.cpu() for t in (*dec, *m.scale.resize_yuv420(
                *dec, H, W))]
        assert all(torch.equal(a, b) for a, b in zip(planes[dev.type],
                                                     planes["cpu"])), name
        if name == "prog":
            got = m.mjpeg.decode_mjpeg_frames(base, device=dev)
            assert all(torch.equal(a, b.cpu()) for a, b in
                       zip(planes["cpu"][:3], got)), \
                "progressive planes differ from the baseline decode"
        else:
            for a, b in zip(planes["cpu"][:3], (y, cb, cr)):
                assert np.array_equal(a.numpy(), b), "lossless != pictures"
            for i, (mode, pl, _) in enumerate(plain):
                assert mode == "yuv" and all(np.array_equal(
                    a[i].numpy(), b) for a, b in zip(planes["cpu"][:3], pl))
        sy, scb, scr = (t.numpy() for t in planes["cpu"][3:])
        uniq = [m.native.ref_encode_frame(sy[i], scb[i], scr[i], QSCALE)
                for i in range(n_unique)]
        assert out.video_chunks == [uniq[i % n_unique]
                                    for i in range(n_frames)], name
        # both files carry the same PCM: the CPU route's audio once (phase
        # 12 holds this route against the ADPCM oracle)
        if audio is None:
            pcm_r = m.resample.resample_pcm(
                m.avi.extract_pcm(ast, device=cpu), AVI_RATE, RATE,
                device=cpu).numpy()
            audio = m.amv_audio.encode_stream(pcm_r, frame_size, RATE,
                                              device=cpu)
        assert out.audio_chunks == audio, name
        log(f"{name}: the card's decoded and scaled planes of the "
            f"{n_unique} distinct frames equal the CPU route's" +
            (", and the baseline decode of the same coefficients"
             if name == "prog" else ", the pictures, and the plain Python "
             "walk's (decode_lossless(native=False), in the workers)") +
            "; video byte-identical to the C encoder of them; audio the "
            "CPU route's")

        # the stages one by one, all frames at once, a sync after each
        split = {}

        def read():
            with open(src, "rb") as f:
                return f.read()

        data = staged(split, "read", read)
        vst, ast = staged(split, "demux", lambda: m.avi.demux(data))
        chunks, dec = vst.chunks, None
        if name == "prog":
            scans = staged(split, "parse headers", lambda: [
                m.jpeg_progressive.parse_scans(c) for c in chunks])
            host = torch.empty((n_frames, mb_w * mb_h, 6, 64),
                               dtype=torch.int16, pin_memory=True)
            hn = host.numpy()

            def walk(part):
                for j in part:
                    hn[j] = m.jpeg_progressive.decode_scans(scans[j])[0]

            staged(split, "host C walk", lambda: m.mjpeg._threads(
                walk, range(n_frames)))
            lv_d = staged(split, "upload", lambda: host.to(
                dev, non_blocking=True))
            f0 = scans[0].frame
            qm = np.stack([f0.quant[c[3]] for c in f0.components
                           for _ in range(c[1] * c[2])])
            raster = staged(split, "device dequant", lambda: (
                m.mjpeg.dequantize(lv_d, qm, "420", dc_absolute=True)))
            del lv_d, host, hn, scans
            pix = staged(split, "device I (idct_put)",
                         lambda: m.idct.idct_put(raster))
            dec = staged(split, "device assembly", lambda: [
                t.clone() for t in m.mjpeg.assemble(pix, "420", mb_w, mb_h,
                                                    AVI_W, AVI_H)])
            del pix
            p420 = staged(split, "device to 4:2:0", lambda: (
                m.avi.mjpeg_to_yuv420(*dec, AVI_W, AVI_H)))
        else:
            tables = {}
            ps = staged(split, "parse headers", lambda: [
                m.jpeg_lossless.parse_frame(c, tables) for c in chunks])
            size = [r * c for r, c in ps[0].shapes]
            off = np.cumsum([0] + size)
            host = torch.empty((n_frames, int(off[-1])), dtype=torch.uint8,
                               pin_memory=True)
            hn = host.numpy()

            def walk(part):
                for j in part:
                    m.jpeg_lossless.decode_into(ps[j], hn[j], off[:-1])

            staged(split, "host C walk", lambda: m.mjpeg._threads(
                walk, range(n_frames)))
            pl_d = staged(split, "upload", lambda: host.to(
                dev, non_blocking=True))
            del ps, host, hn
            p420 = staged(split, "device to 4:2:0", lambda: (
                m.avi._to_yuv420(*(pl_d[:, o:o + s].reshape(
                    n_frames, r, c).contiguous() for o, s, (r, c) in zip(
                        off.tolist(), size, ((AVI_H, AVI_W),
                                             (AVI_H // 2, AVI_W // 2),
                                             (AVI_H // 2, AVI_W // 2)))),
                    AVI_W, AVI_H)))
            del pl_d
        scaled = staged(split, "device scale", lambda: (
            m.scale.resize_yuv420(*p420, H, W)))
        lv_e = staged(split, "device V", lambda: m.V.encode_planes(
            *scaled, QSCALE))
        bits = staged(split, "device E count", lambda: m.E.count_bits(lv_e))
        words, bits, _ = staged(split, "device E", lambda: (
            m.E.encode_levels(lv_e, m.amv_video.used_words(bits))))
        w_np, b_np = staged(split, "device->host words", lambda: (
            words.cpu().numpy(), bits.cpu().numpy()))
        vch = staged(split, "escape", lambda: m.native.escape_frames(w_np,
                                                                     b_np))
        pcm_d = staged(split, "audio extract", lambda: m.avi.extract_pcm(
            ast, device=dev))
        pcm_h = staged(split, "device resample + to host", lambda: (
            m.resample.resample_pcm(pcm_d, AVI_RATE, RATE,
                                    device=dev).cpu().numpy()))
        achunks = staged(split, "audio Q", lambda: (
            m.amv_audio.encode_stream(pcm_h, frame_size, RATE, device=dev)))
        staged(split, "mux", lambda: m.riff.mux(
            vch, achunks, width=W, height=H, fps=FPS, sample_rate=RATE))
        assert vch == out.video_chunks and achunks == out.audio_chunks, name
        log_split(f"{card}: {key}", split, f"; {n_frames} frames, all at "
                  "once (the CLI decodes and scales in batches of 1,024)")
        if name == "prog":
            batch = min(n_frames, m.avi.BATCH_FRAMES)
            check("I progressive", lambda: (m.idct.idct_put(raster[:batch]),),
                  lambda: (m.idct.idct_put_plain(
                      raster[:batch].reshape(-1, 64)).reshape(
                      raster[:batch].shape),),
                  f"{raster[:batch].numel() // 64} blocks ({batch} frames of "
                  "4:2:0, the CLI's batch)", raster[:batch].numel() * 3,
                  raster[:batch].numel() // 64 * OPS_IDCT)
            del raster
        del data, vst, dec, p420, scaled, lv_e, words

    # the 64 check frames, card against CPU
    for key, frames in checks.items():
        if key.startswith("rgb"):
            got = m.mjpeg.decode_lossless_frames(frames, device=dev)
            want = m.mjpeg.decode_lossless_frames(frames, device=cpu)
            assert got[0] == want[0] == "rgb", key
            got, want = got[1], want[1]
        else:
            got = m.mjpeg.decode_mjpeg_frames(frames, device=dev)
            want = m.mjpeg.decode_mjpeg_frames(frames, device=cpu)
        assert all((a is None and b is None) or torch.equal(a.cpu(), b)
                   for a, b in zip(got, want)), key
    lv8, _ = m.jpeg_progressive.decode_progressive(checks["per-scan tables"][0])
    assert lv8[0, 0, 0] == 5 and lv8[0, 0, 1] == 3 and lv8[0, 0, 6] == -2
    rgb = m.avi.AviStream("video", codec=b"MJPG", width=cw, height=ch,
                          chunks=checks["rgb rct"])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(
        m.avi.extract_yuv420(rgb, device=dev),
        m.avi.extract_yuv420(rgb, device=cpu))), "rgb extract"
    log(f"{card}: {sum(map(len, checks.values()))} check frames at {cw}x{ch}"
        f" ({', '.join(checks)}): planes on the card equal the CPU route's")
    log(f"phase 18 took {time.perf_counter() - t18:.1f} s")


def g729_phase(m, dev, paths, card, kern, extra, tmp, mhz, g_sass,
               n_streams=G_STREAMS, n_frames=G_FRAMES,
               file_reps=G_FILE_REPS, n_check=G_CHECK,
               n_oracle=G_ORACLE) -> None:
    """Phase 15: G.729A.  A dictaphone's recordings in bulk, n_streams of
    n_frames seeded frames each (1% erasures, 1% bad parity, 5% pitch
    codes >= 197; stream 1 erased for its first 3 frames and at the
    largest pitch gain, so its LP synthesis overflows; stream 2 with the
    least pitch code), through decode_streams on the card: kernel G
    launched once, its time beside the bounds (g_sass: a future of G's
    nvdisasm listing, for its latency floor at mhz: the longest pipeline
    stage's chain); G against its plain
    version on the card for every stream's first n_check frames and for
    two windows of n_check frames in the middle, each from the state G
    returned at that frame; streams 0 and 3's first n_oracle frames
    against the scalar oracle (verify/ref_g729.py).  Then one file: stream
    0's frames file_reps times over, written with act.mux, through
    `cli.main -i rec.act out.wav` x3 (frames/s, the stages one by one)
    and out.bit; its first n_frames * 80 samples equal stream 0's."""
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cpu = torch.device("cpu")
    t15 = time.perf_counter()
    rng = np.random.default_rng(15)
    frames = m.fixtures.g729_frames(rng, n_frames, n_streams, erasure=0.01,
                                    bad_parity=0.01, high_pitch=0.05)
    frames[0, [0, 3]] = m.fixtures.g729_frames(rng, 1, 2)[0]
    m.fixtures.g729_loud(frames[:, 1])
    frames[:3, 1] = 0
    m.fixtures.g729_set_field(frames[2, 2], 18, 8, 0)     # P1 = 0
    m.fixtures.g729_set_field(frames[2, 2], 26, 1, 1)
    n_all = n_streams * n_frames
    log(f"G.729A batch: {n_streams} streams x {n_frames} frames "
        f"({n_frames / 100:.0f} s each), {frames.nbytes / 1e6:.1f} MB in, "
        f"{n_all * 160 / 1e6:.1f} MB of PCM out; "
        f"{time.perf_counter() - t15:.1f} s to make")

    # the batch through decode_streams: one launch of G
    fr = torch.from_numpy(frames).to(dev)
    sync()
    reset_launches(m)
    t0 = time.perf_counter()
    pcm = m.g729a.decode_streams(fr)
    sync()
    wall = time.perf_counter() - t0
    paths["g729 batch"] = launches(m)
    assert paths["g729 batch"]["G"] == 1, paths["g729 batch"]
    assert pcm.shape == (n_streams, n_frames * 80) and \
        pcm.dtype == torch.int16
    parms = m.g729a.unpack_frames(fr)
    st0 = m.g729a.init_state(n_streams, device=dev)
    g_ms, (st_end, pcm_g) = cuda_ms(
        lambda: m.g729a.decode_frames_scan(st0, parms), 3)
    assert torch.equal(pcm_g.permute(1, 0, 2).reshape(n_streams, -1), pcm)
    bms, by = bound(n_all * (10 + 160), n_all * OPS_G729)
    floor = m.tools_g.g729_floor(g_sass.result(),
                                 m.tools_t._csrc(m._build))
    frame_ms = floor["cycles"] / (mhz * 1e3)     # a frame's floor
    batch = {"streams": n_streams, "frames": n_frames, "ms": g_ms,
             "bound_ms": bms, "bound_by": by,
             "latency_floor_ms": n_frames * frame_ms,
             "frames_s": n_all / g_ms * 1e3,
             "real_time_factor": n_all * 10.0 / g_ms,
             "decode_streams_s": wall}
    log(f"G at {n_streams} x {n_frames} frames: {g_ms:.3f} ms a launch "
        f"(median of 3, CUDA events), decode_streams {wall:.3f} s (host "
        f"clock, first call); {n_all / g_ms / 1e3:.1f} M frames/s, real-time"
        f" factor {n_all * 10.0 / g_ms:.0f}; bound {bms:.4f} ms by {by} "
        f"({n_all * 170 / 1e6:.0f} MB, {n_all * OPS_G729 / 1e9:.1f} G int "
        f"ops); latency floor {n_frames * frame_ms:.3f} ms ({n_frames} "
        f"frames x {floor['instructions']} dependent instructions, the "
        f"{floor['binding']} stage's, x {m.tools_g.DEP_CYCLES} cycles at "
        f"{mhz:.0f} MHz, from the SASS built in this run; stages "
        + ", ".join(f"{k} {v['chain']} {v['parts']}"
                    for k, v in floor["stages"].items()) + ")")

    # G against its plain version: the first n_check frames of every
    # stream, then two windows from G's own state at their first frame
    def window(at):
        st = st0
        if at:
            st, _ = m.g729a.decode_frames_scan(st0, parms[:at])
        got = m.g729a.decode_frames_scan(st, parms[at:at + n_check])
        sync()
        t0 = time.perf_counter()
        sp, want = st, []
        for i in range(at, at + n_check):
            sp, w = m.g729a.decode_frame_batch(sp, parms[i])
            want.append(w)
        sync()
        plain_s = time.perf_counter() - t0
        pairs = [(got[1], torch.stack(want)),
                 (got[1], pcm_g[at:at + n_check])]
        pairs += [(got[0][k], sp[k]) for k, _ in m.g729a.STATE_FIELDS]
        return pairs, plain_s

    wins = (0, n_frames // 3, min((2 * n_frames) // 3 + 7, n_frames - n_check))
    plain_s = []
    for at in wins:
        pairs, t = window(at)
        plain_s.append(t)
        extra("G" if at == 0 else f"G window {at}", pairs,
              f"{n_streams} streams, frames {at}-{at + n_check - 1}, PCM "
              "and state" + (f", from G's state at frame {at}" if at
                             else ""))
    # the kernels line's ms, plain_ms and bound_ms: one work, the first
    # window's (the plain version at the batch's frames would take ~20 min)
    check_ms = cuda_ms(lambda: m.g729a.decode_frames_scan(
        st0, parms[:n_check]), 3)[0]
    n_win = n_streams * n_check
    bms_c, by_c = bound(n_win * (10 + 160), n_win * OPS_G729)
    kern["G"] = {"ms": check_ms, "plain_ms": 1e3 * plain_s[0],
                 "bound_ms": bms_c, "bound_by": by_c, "streams": n_streams,
                 "frames": n_check, "latency_floor_ms": n_check * frame_ms,
                 "floor_instructions": floor["instructions"],
                 "floor_stages": {k: v["chain"]
                                  for k, v in floor["stages"].items()},
                 "batch": batch}
    log(f"G at {n_streams} x {n_check} frames: kernel {check_ms:.3f} ms, "
        f"plain {plain_s[0] * 1e3:.1f} ms (host clock; windows "
        f"{', '.join(f'{t * 1e3:.1f}' for t in plain_s[1:])} ms); bound "
        f"{bms_c:.4f} ms by {by_c}, latency floor {n_check * frame_ms:.4f}"
        " ms")
    t0 = time.perf_counter()
    got = pcm[[0, 3], :n_oracle * 80].cpu().numpy()
    for row, b in enumerate((0, 3)):
        dec = m.ref_g729.G729Decoder()
        want = np.concatenate([dec.decode_frame(f.tobytes())
                               for f in frames[:n_oracle, b]])
        assert np.array_equal(got[row], want), f"stream {b} != the oracle"
    log(f"G: streams 0 and 3, frames 0-{n_oracle - 1}, equal the scalar "
        f"oracle ({time.perf_counter() - t0:.1f} s)")

    # one 10-minute file through the user's entry point
    src = os.path.join(tmp, "rec.act")
    data = m.act.mux(np.tile(frames[:, 0], (file_reps, 1)))
    with open(src, "wb") as f:
        f.write(data)
    n_file = len(m.act.demux(data)[0])
    reset_launches(m)
    wall, walls = timed_cli(m, ["-i", src, os.path.join(tmp, "rec.wav"),
                                "--device", dev.type])
    paths["g729 file"] = launches(m)
    assert paths["g729 file"]["G"] == 3, paths["g729 file"]
    out, rate = m.wav.read_pcm(os.path.join(tmp, "rec.wav"), device=cpu)
    assert rate == 8000 and out.shape == (n_file * 80,)
    assert torch.equal(out[:n_frames * 80], pcm[0].cpu()), \
        "the file's first frames differ from stream 0 of the batch"
    bit = os.path.join(tmp, "rec.bit")
    assert m.cli.main(["-i", src, bit]) == 0
    words = np.fromfile(bit, "<u2").reshape(-1, 82)
    assert (words[:, 0] == 0x6B21).all() and (words[:, 1] == 80).all()
    assert set(np.unique(words[:, 2:]).tolist()) <= {0x7F, 0x81}
    assert np.array_equal(np.packbits(words[:, 2:] == 0x81, axis=1),
                          m.act.demux(data)[0]), ".bit != the ACT frames"
    split = {}
    raw = staged(split, "read", lambda: open(src, "rb").read())
    fr1, rate1, _ = staged(split, "demux", lambda: m.act.demux(raw))
    p1 = staged(split, "upload + unpack", lambda: m.g729a.unpack_frames(
        m.pipeline.upload(fr1[:, None], dev)))
    _, pcm1 = staged(split, "device G", lambda: m.g729a.decode_frames_scan(
        m.g729a.init_state(1, device=dev), p1))
    staged(split, "device->host + write", lambda: m.wav.write_pcm(
        os.path.join(tmp, "rec2.wav"), pcm1.reshape(-1).cpu().numpy(),
        rate1))
    kern["G"]["file"] = {"frames": n_file, "cli_s": walls,
                         "frames_s": n_file / wall,
                         "real_time_factor": n_file / 100 / wall,
                         "g_s": split["device G"]}
    log(f"{card}: G.729A, cli.main -i rec.act out.wav x3 ({n_file} frames, "
        f"{n_file / 6000:.1f} min, {len(data)} bytes): "
        f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s = "
        f"{n_file / wall:.0f} frames/s, real-time factor "
        f"{n_file / 100 / wall:.0f}; launches {paths['g729 file']}; the "
        f"first {n_frames} frames equal stream 0 of the batch; out.bit "
        "equal to the file's frames' bits")
    log_split("G.729A file", split)
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s")


def seg_quality(ref, out):
    """(corr, segSNR dB) of decoded PCM against its input, as
    tests/test_g729_encoder_tpu.py measures them: from sample 400 on,
    segments of 160 whose input power passes 1e4."""
    a, r = out[400:].astype(float), ref[400:].astype(float)
    n = (len(a) - 1) // 160 * 160
    e = ((a[:n] - r[:n]) ** 2).reshape(-1, 160).mean(1)
    p = (r[:n] ** 2).reshape(-1, 160).mean(1)
    seg = 10 * np.log10(np.maximum(p, 1) / np.maximum(e, 1))[p > 1e4]
    return float(np.corrcoef(a, r)[0, 1]), float(seg.mean())


def g729_encode_phase(m, dev, paths, card, kern, extra, tmp, k_libs,
                      n_streams=K_STREAMS, n_frames=K_FRAMES,
                      n_check=K_CHECK, cli_frames=K_CLI_FRAMES,
                      shapes=K_TURNS) -> None:
    """Phase 16: G.729A encoding.  n_streams seeded speech recordings of
    n_frames frames through encode_streams on the card: kernel K launched
    once (its launches counted from 0), its time beside its bound (float
    operations over the FP32 lanes' rate, shared loads over the load
    units'), frames/s; with k_libs (a future of time_g729.k_libraries'
    builds; None skips this) K in turns with its first design at each of
    `shapes` (streams x frames; outputs equal) and both designs' time by
    phase at the first; K against its plain version
    on the card, parameters, state and hist, for every stream's first
    n_check frames and a window of n_check from K's own state mid-stream;
    the frames decoded by G to K's shadow state; decode(encode(x))'s
    quality.  Then cli.main -i in.wav -f act on a 22,050 Hz stereo WAV at
    --max-frames cli_frames (the host encoder, after the resampling on the
    card), timed; its file decoded by G against the input's 8 kHz mono
    mean (the CPU route's equality with the JAX package's file is a CPU
    test, tests/test_torch_g729_encoder.py)."""
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t16 = time.perf_counter()
    pcm = m.fixtures.speech_streams(n_streams, n_frames * 80, 16)
    n_all = n_streams * n_frames
    log(f"G.729A encode: {n_streams} streams x {n_frames} frames "
        f"({n_frames / 100:.0f} s each) of seeded speech; "
        f"{time.perf_counter() - t16:.1f} s to make")
    x = torch.from_numpy(pcm).to(dev)
    sync()
    reset_launches(m)
    t0 = time.perf_counter()
    packed = m.g729_enc.encode_streams(x)
    sync()
    wall = time.perf_counter() - t0
    paths["g729 encode"] = launches(m)
    assert paths["g729 encode"]["K"] == 1, paths["g729 encode"]
    assert packed.shape == (n_frames, n_streams, 10) and \
        packed.dtype == torch.uint8
    fr = x.float().reshape(n_streams, n_frames, 80).permute(1, 0, 2) \
        .contiguous()
    st0 = m.g729a.init_state(n_streams, device=dev)
    h0 = torch.zeros((n_streams, 160), dtype=torch.float32, device=dev)
    k_ms, (st_k, h_k, parms_k) = cuda_ms(
        lambda: m.g729_enc.encode_frames_scan(st0, h0, fr), 3)
    assert torch.equal(m.g729_enc.pack_frames(parms_k), packed)
    bms, by = bound(n_all * (320 + 64), n_all * OPS_G729_ENCODE, fp32=True)
    lds_ms = 1e3 * n_all * LDS_G729_ENCODE / m.roofline.LDS_S
    batch = {"streams": n_streams, "frames": n_frames, "ms": k_ms,
             "bound_ms": bms, "bound_by": by, "lds_ms": lds_ms,
             "frames_s": n_all / k_ms * 1e3,
             "real_time_factor": n_all * 10.0 / k_ms,
             "encode_streams_s": wall}
    log(f"K at {n_streams} x {n_frames} frames: {k_ms:.3f} ms a launch "
        f"(median of 3, CUDA events), encode_streams {wall:.3f} s (host "
        f"clock, first call); {n_all / k_ms * 1e3:.0f} frames/s, real-time "
        f"factor {n_all * 10.0 / k_ms:.0f}; bound {bms:.3f} ms by {by} "
        f"({OPS_G729_ENCODE} float operations a frame over the FP32 lanes' "
        f"{m.roofline.FP32_INSN_S / 1e12:.1f} T/s); shared loads "
        f"{LDS_G729_ENCODE} a frame over {m.roofline.LDS_S / 1e12:.2f} T/s: "
        f"{lds_ms:.3f} ms")
    if k_libs is not None:
        libs = k_libs.result()
        turns = {}
        for b, t in shapes:
            if (b, t) == (n_streams, n_frames):
                st_t, h_t, fr_t = st0, h0, fr
            else:
                x_t = torch.from_numpy(m.fixtures.speech_streams(
                    b, t * 80, 16)).to(dev)
                fr_t = x_t.float().reshape(b, t, 80).permute(1, 0, 2) \
                    .contiguous()
                st_t = m.g729a.init_state(b, device=dev)
                h_t = torch.zeros((b, 160), dtype=torch.float32, device=dev)
            turns[f"{b}x{t}"] = m.tools_g.k_turns(
                m.g729_enc, libs["baseline"], st_t, h_t, fr_t, 3)
            log(f"K in turns with its first design at {b} x {t} (baseline, "
                f"K, K, baseline; CUDA events, median of 3 each): baseline "
                f"{turns[f'{b}x{t}']['baseline_ms']} ms, K "
                f"{turns[f'{b}x{t}']['tree_ms']} ms; parameters, state and "
                "hist equal")
        phases = {name: m.tools_g.k_phases(libs[f"{name} phases"], st0, h0,
                                           fr)
                  for name in ("baseline", "tree")}
        for name, ph in phases.items():
            log(f"K's time by phase, {name} design, at {n_streams} x "
                f"{n_frames} (cycles a frame a CTA, thread 0's clock64() "
                f"between stamps; the profile build's launch "
                f"{ph['ms']:.1f} ms): total {ph['total']:.0f}: "
                + ", ".join(f"{k} {v:.0f}" for k, v in ph["cycles"].items()))
        batch["turns"] = turns
        batch["phases"] = {name: {k: round(v) for k, v in
                                  ph["cycles"].items()}
                           for name, ph in phases.items()}

    # K against its plain version: every stream's first n_check frames,
    # then a window from K's own state in the middle
    def window(at):
        st, h = st0, h0
        if at:
            st, h, _ = m.g729_enc.encode_frames_scan(st0, h0, fr[:at])
        got = m.g729_enc.encode_frames_scan(st, h, fr[at:at + n_check])
        sync()
        t0 = time.perf_counter()
        sp, hp, want = st, h, []
        for i in range(at, at + n_check):
            sp, hp, p = m.g729_enc.encode_frame_batch(sp, hp, fr[i])
            want.append(p)
        sync()
        plain_s = time.perf_counter() - t0
        # hist's float32 compared by its bits
        pairs = [(got[2], torch.stack(want)),
                 (got[2], parms_k[at:at + n_check]),
                 (got[1].view(torch.int32), hp.view(torch.int32))]
        pairs += [(got[0][k], sp[k]) for k, _ in m.g729a.STATE_FIELDS]
        return pairs, plain_s

    plain_s = []
    for at in (0, n_frames // 2 + 3):
        pairs, t = window(at)
        plain_s.append(t)
        extra("K" if at == 0 else f"K window {at}", pairs,
              f"{n_streams} streams, frames {at}-{at + n_check - 1}, "
              "parameters, state and hist" + (f", from K's state at frame "
                                              f"{at}" if at else ""))
    check_ms = cuda_ms(lambda: m.g729_enc.encode_frames_scan(
        st0, h0, fr[:n_check]), 3)[0]
    n_win = n_streams * n_check
    bms_c, by_c = bound(n_win * (320 + 64), n_win * OPS_G729_ENCODE,
                        fp32=True)
    # the frames through G: its state is K's shadow state
    st_g, pcm_g = m.g729a.decode_frames_scan(
        m.g729a.init_state(n_streams, device=dev),
        m.g729a.unpack_frames(packed))
    for k in m.g729_enc.TRACKED:
        assert torch.equal(st_g[k], st_k[k]), f"G's {k} != K's"
    dec = pcm_g.permute(1, 0, 2).reshape(n_streams, -1).cpu().numpy()
    q = np.array([seg_quality(pcm[i], dec[i]) for i in range(n_streams)])
    # the bars of tests/test_g729_encoder_tpu.py, over the streams' mean
    assert q[:, 0].mean() > 0.8 and q[:, 1].mean() > 4.0, q.mean(0)
    kern["K"] = {"ms": check_ms, "plain_ms": 1e3 * plain_s[0],
                 "bound_ms": bms_c, "bound_by": by_c, "streams": n_streams,
                 "frames": n_check, "batch": batch,
                 "quality": {"corr_min": float(q[:, 0].min()),
                             "corr_mean": float(q[:, 0].mean()),
                             "segsnr_min": float(q[:, 1].min()),
                             "segsnr_mean": float(q[:, 1].mean())}}
    log(f"K at {n_streams} x {n_check} frames: kernel {check_ms:.3f} ms, "
        f"plain {plain_s[0] * 1e3:.1f} ms (host clock; the window "
        f"{plain_s[1] * 1e3:.1f} ms); bound {bms_c:.4f} ms by {by_c}; G "
        f"decodes K's frames to K's state; decode(encode(x)) corr min "
        f"{q[:, 0].min():.4f} mean {q[:, 0].mean():.4f}, segSNR min "
        f"{q[:, 1].min():.2f} mean {q[:, 1].mean():.2f} dB")

    # cli.main -f act: the host encoder after the resampling on the card
    src = os.path.join(tmp, "speech.wav")
    one = m.fixtures.speech_streams(1, int(22050 * cli_frames / 100)
                                    + 2205, 17)[0]
    stereo = np.stack([one, one // 2], 1)
    m.wav.write_pcm(src, stereo, 22050, 2)
    out = os.path.join(tmp, "speech.act")
    reset_launches(m)
    t0 = time.perf_counter()
    assert m.cli.main(["-i", src, "-f", "act", out, "--device", dev.type,
                       "--max-frames", str(cli_frames)]) == 0
    cli_s = time.perf_counter() - t0
    paths["g729 cli encode"] = launches(m)
    with open(out, "rb") as f:
        got = m.act.demux(f.read())[0][:cli_frames]
    assert len(got) == cli_frames and got.any(1).all()
    mono = m.resample.resample_pcm(m.wav_audio.downmix(
        torch.from_numpy(stereo)), 22050, 8000, device="cpu").numpy()
    dec = m.g729a.decode_streams(torch.from_numpy(got[:, None]).to(dev))
    c, snr = seg_quality(mono[:cli_frames * 80], dec[0].cpu().numpy())
    assert c > 0.8, c
    kern["K"]["cli"] = {"frames": cli_frames, "s": cli_s,
                        "frames_s": cli_frames / cli_s, "corr": c,
                        "segsnr": snr}
    log(f"{card}: cli.main -i speech.wav (22,050 Hz stereo) -f act "
        f"--max-frames {cli_frames}: {cli_s:.2f} s = "
        f"{cli_frames / cli_s:.2f} frames/s (the host encoder, \"high\"); "
        f"decoded by G: corr {c:.4f}, segSNR {snr:.2f} dB against the "
        f"resampled mono input; launches {paths['g729 cli encode']}")
    log(f"phase 16 took {time.perf_counter() - t16:.1f} s")


def _same(name, got, want) -> None:
    """got and want (tensors, or tuples or dicts of them) equal, bit for
    bit."""
    import torch
    if isinstance(want, dict):
        for k in want:
            _same(f"{name}[{k}]", got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _same(f"{name}[{i}]", g, w)
    elif not (got.dtype == want.dtype and torch.equal(got, want.to(
            got.device))):
        raise AssertionError(f"{name}: the sharded result differs from the "
                             "single-device function's")


def mesh_checks(m, mesh, pays, rng, n_small=64) -> list:
    """Every sharded_* of parallel/sharding.py on `mesh` against the port's
    single-device function on the first device, at small shapes: the
    corpus's first n_small frames (decode step with frames on dp and MCUs
    on sp, encode step, entropy decode, decode chain, encode chain, fused
    transcode step, complete transcode and its ok per shard), 64 random
    ADPCM chunks and 16 streams, 8 G.729A streams of 16 frames and their
    encode.  Returns the names checked."""
    import torch
    S, dev = m.sharding, mesh.flat[0]
    n_mcu, mb_w, mb_h = ((W + 15) // 16) * ((H + 15) // 16), W // 16, \
        (H + 15) // 16
    rows, lens = m.native.unescape_frames(pays[:n_small])
    rows, lens = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    done = []

    def same(name, got, want):
        _same(name, got, want)
        done.append(name)

    lv, ok = m.D.decode_scans(rows, lens, 6 * n_mcu)
    lv4 = lv.view(-1, n_mcu, 6, 64)
    same("sharded_entropy_decode",
         S.sharded_entropy_decode(mesh, n_mcu)(rows, lens), (lv4, ok))
    planes = m.amv_video.decode_transform(lv4, mb_w, mb_h, W, H)
    same("sharded_decode_step",
         S.sharded_decode_step(mesh, mb_w, mb_h, W, H)(lv4), planes)
    same("sharded_encode_step", S.sharded_encode_step(mesh, mb_w, mb_h)(
        *planes), m.amv_video.encode_transform(*planes, mb_w, mb_h))
    dc = m.amv_video.resolve_dc(lv4).view(-1)
    same("sharded_decode_scans", S.sharded_decode_scans(mesh, W, H)(
        rows, lens), (*m.amv_video.decode_planes(lv.view(-1, 64), dc, W, H),
                      ok))
    same("sharded_encode_planes", S.sharded_encode_planes(
        mesh, mb_w, mb_h, QSCALE)(*planes), m.amv_video.pack_levels(
            m.amv_video.encode_planes(*planes, QSCALE, "ffmpeg")))
    same("sharded_transcode_step", S.sharded_transcode_step(
        mesh, QSCALE, (W, H))(lv4), m.P.transcode_levels_fused(
            lv4, QSCALE, (W, H)))
    one = m.P.transcode_complete(rows, lens, n_mcu, QSCALE, (W, H))
    same("sharded_complete_transcode", S.sharded_complete_transcode(
        mesh, n_mcu, QSCALE, (W, H))(rows, lens), one)
    words, bits, ok_s = S.sharded_complete_transcode_async(
        mesh, n_mcu, QSCALE, (W, H))(rows, lens)
    same("sharded_complete_transcode_async", (words, bits), one[:2])
    assert ok_s.tolist() == [1] * mesh.size, ok_s

    pay = torch.from_numpy(rng.integers(0, 256, (64, 512), np.uint8))
    pred = torch.from_numpy(rng.integers(-30000, 30000, 64, np.int32))
    sidx = torch.from_numpy(rng.integers(0, 89, 64, np.int32))
    same("sharded_adpcm_decode", S.sharded_adpcm_decode(mesh)(
        pay, pred, sidx), m.adpcm.decode_chunks(
            *(t.to(dev) for t in (pay, pred, sidx))))
    x = torch.from_numpy(rng.integers(-32768, 32768, (16, 4096), np.int16))
    reset = torch.zeros(x.shape, dtype=torch.bool)
    reset[:, 0] = reset[5, 2048] = True
    s0 = torch.from_numpy(rng.integers(0, 89, 16, np.int32))
    same("sharded_adpcm_encode", S.sharded_adpcm_encode(mesh)(x, reset, s0),
         m.adpcm.encode_streams(*(t.to(dev) for t in (x, reset, s0))))

    parms = m.g729a.unpack_frames(torch.from_numpy(
        m.fixtures.g729_frames(rng, 16, 8, erasure=0.05)).to(dev))
    want = m.g729a.decode_frames_scan(m.g729a.init_state(8, device=dev),
                                      parms)
    for name in ("sharded_g729_decode_scan", "sharded_g729_decode_chain"):
        same(name, getattr(S, name)(mesh)(m.g729a.init_state(8, device=dev),
                                          parms), want)
    fr = torch.from_numpy(m.fixtures.speech_streams(8, 16 * 80, 5)).to(
        dev).float().view(8, 16, 80).permute(1, 0, 2).contiguous()
    st0 = m.g729a.init_state(8, device=dev)
    h0 = torch.zeros((8, 160), device=dev)
    same("sharded_g729_encode_scan", S.sharded_g729_encode_scan(mesh)(
        st0, h0, fr), m.g729_enc.encode_frames_scan(st0, h0, fr))
    st1, h1, p1 = m.g729_enc.encode_frames_scan(st0, h0, fr[:1])
    same("sharded_g729_encode_step", S.sharded_g729_encode_step(mesh)(
        st0, h0, fr[0]), (st1, h1, p1[0]))
    return done


def sharding_phase(m, dev, paths, card, pays, want) -> None:
    """Phase 19: multi-GPU sharding on the card.  Every sharded_* on a
    virtual mesh of 4 positions of the one card (dp 2 x sp 2, each its own
    stream) against the single-device function, bit for bit
    (`mesh_checks`), the kernels launched counted; AsyncTranscoder(mesh=
    2 positions of the card) over phase 11's 9,600 frames (the corpus
    twice), bytes equal to phase 11's, frames/s as a one-card virtual
    mesh's; where the machine has two or more cards, the same on a mesh
    of every card."""
    import torch
    t19 = time.perf_counter()
    rng = np.random.default_rng(19)
    one = f"{dev.type}:0" if dev.type == "cuda" else "cpu"
    n_mcu = ((W + 15) // 16) * ((H + 15) // 16)
    meshes = [("virtual", [one] * 4, [one] * 2)]
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= 2:
        meshes.append(("cards", [f"cuda:{i}" for i in range(n_cards)],
                       [f"cuda:{i}" for i in range(n_cards)]))
    else:
        log(f"phase 19: {n_cards} card(s) on this machine, no second card: "
            "the mesh across cards is not run, multi-card scaling not "
            "measured")
    for label, devs4, devs2 in meshes:
        mesh = m.sharding.make_mesh(devs4)
        reset_launches(m)
        done = mesh_checks(m, mesh, pays, rng)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        paths[f"sharding {label}"] = got = launches(m)
        assert all(got[k] > 0 for k in "DTEIUVAQGK"), got
        log(f"phase 19 ({label} mesh {mesh.shape} on "
            f"{[str(d) for d in mesh.flat]}): {len(done)} sharded functions "
            f"bit for bit against the single-device ones: {', '.join(done)}"
            f"; launches {got}")
        server_mesh = m.sharding.make_mesh(devs2)

        def server():
            return m.S.AsyncTranscoder(n_mcu, QSCALE, batch_frames=1024,
                                       depth=4, size=(W, H),
                                       mesh=server_mesh)

        reset_launches(m)
        assert server().transcode(pays + pays) == want + want, label
        paths[f"serving mesh {label}"] = got = launches(m)
        assert all(got[k] > 0 for k in "DTE"), got
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            assert server().transcode(pays + pays) == want + want
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        log(f"{card}: AsyncTranscoder(batch_frames=1024, depth=4, mesh="
            f"{[str(d) for d in server_mesh.flat]}) ({label}) over "
            f"{2 * len(pays)} frames: bytes equal to phase 11's; "
            f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s "
            f"= {2 * len(pays) / wall:.1f} frames/s; launches {got}")
    log(f"phase 19 took {time.perf_counter() - t19:.1f} s")


def device_ms(fn, names, reps=5, tries=3):
    """Device milliseconds a call of fn spends in kernels whose name holds
    one of `names`, from torch.profiler's kernel times over reps calls;
    None (logged, with the events it saw) when the profiler records no
    such kernel in `tries` sessions: on the H100 a session now and then
    records the runtime calls but not the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, seen = 0.0, []
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            t = getattr(ev, "cuda_time_total", 0) if t is None else t
            seen.append(ev.key[:60])
            if any(n in ev.key for n in names):
                us += t
        if us > 0:
            return us / 1e3 / reps
    log(f"torch.profiler saw no device time for {names} in {tries} "
        f"sessions (not measured); its events: {seen}")
    return None


def burst_ms(fn, reps=20):
    """Milliseconds a call of fn over reps calls issued back to back
    between two CUDA events (the launches queue ahead of the card, so the
    host work around each is hidden): the median of 3 bursts."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def pixel_phase(m, dev, paths, card, check, extra, kern, data, pays, tmp,
                ptx, n_oracle=Y_ORACLE, oracle_workers=4) -> None:
    """Phase 17: pixel outputs and amvlib on the corpus (data, its
    payloads pays).  Kernel Y against its plain version, bit for bit, in
    every format at the corpus's size (the 16-bit formats also undithered),
    YUYV/UYVY on the card against the CPU, and every format's first
    n_oracle frames against the scalar oracle (verify/ref_yuv2rgb.py, in a
    pool of worker processes); kernel W's two entries against their plain
    versions on every frame; for each the median CUDA-event ms, the device
    ms (torch.profiler), the bound and ptxas's lines.  Then cli.main to
    .rgb (rgb24), .raw (rgb565) and %04d.bmp under both --color values,
    each timed and split by stage (read + demux, decode: D, U; convert: Y
    or color; device->host; write), and AmvOpen -> AmvReadNextFrame /
    AmvVideoDecode over every frame on the card, frames/s, each frame equal
    to decode_frames_amvlib_rgb's batch."""
    import torch
    t17 = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n = len(pays)
    pool = concurrent.futures.ProcessPoolExecutor(
        oracle_workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        y, cb, cr = m.amv_video.decode_frames_device(pays, W, H, device=dev)
        host = [p[:n_oracle].cpu().numpy() for p in (y, cb, cr)]
        oracle = {fmt: [pool.submit(m.ref_yuv2rgb.ref_yuv420_to_packed,
                                    host[0][i], host[1][i], host[2][i], fmt)
                        for i in range(n_oracle)]
                  for fmt in m.Y._FORMATS}
        px = n * H * W

        def y_bytes(got):
            return px * 3 // 2 + got[0].numel() * got[0].element_size()

        outs = {}
        for fmt in m.Y._FORMATS:
            key = "Y" if fmt == "rgb24" else f"Y {fmt}"
            outs[fmt] = check(
                key, lambda: (m.Y.yuv420_to_packed(y, cb, cr, fmt=fmt),),
                lambda: (m.Y.yuv420_to_packed_plain(y, cb, cr, fmt=fmt),),
                f"{n} frames {W}x{H}, {fmt}", y_bytes, px * OPS_PIXEL)[0]
            kern[key]["device_ms"] = device_ms(
                lambda: m.Y.yuv420_to_packed(y, cb, cr, fmt=fmt),
                ("yuv2rgb_packed",))
            kern[key]["burst_ms"] = burst_ms(
                lambda: m.Y.yuv420_to_packed(y, cb, cr, fmt=fmt))
        pairs = []
        for fmt in ("rgb565", "bgr565", "rgb555", "bgr555"):
            pairs.append((m.Y.yuv420_to_packed(y, cb, cr, fmt=fmt,
                                               dither=False),
                          m.Y.yuv420_to_packed_plain(y, cb, cr, fmt=fmt,
                                                     dither=False)))
        pairs.append((m.Y.yuv420_to_packed(y, cb, cr, "rgb24", False),
                      m.Y.yuv420_to_packed_plain(y, cb, cr, "rgb24", False)))
        # a key of brightness, contrast and saturation: rgb24 keeps the
        # computed path, rgb32 and rgb565 take the tables
        keyed = (64, 80000, 90000)
        for fmt in ("rgb24", "rgb32", "rgb565"):
            assert (m.Y.register_map(fmt, True, True, *keyed) is None) == \
                (fmt != "rgb24")
            pairs.append((m.Y.yuv420_to_packed(y, cb, cr, fmt, True, True,
                                               *keyed),
                          m.Y.yuv420_to_packed_plain(y, cb, cr, fmt, True,
                                                     True, *keyed)))
        extra("Y undithered", pairs, f"{n} frames, the 16-bit formats "
              "undithered, rgb24 in limited range, and rgb24, rgb32 and "
              f"rgb565 at brightness, contrast, saturation {keyed}")
        cpu = [p.cpu() for p in (y, cb, cr)]
        pk = [(m.Y.yuv420_to_yuyv422(y, cb, cr).cpu(),
               m.Y.yuv420_to_yuyv422(*cpu)),
              (m.Y.yuv420_to_uyvy422(y, cb, cr).cpu(),
               m.Y.yuv420_to_uyvy422(*cpu))]
        extra("Y yuv422", pk, f"{n} frames of YUYV and UYVY (torch.stack on "
              "the card against the CPU)")
        del pk, pairs, cpu
        n_orc = 0
        for fmt, futs in oracle.items():
            got = outs[fmt][:n_oracle].cpu().numpy()
            depth = m.Y._FORMATS[fmt][0]
            if depth == 32:
                got = got.view(np.uint32)
            elif depth in (15, 16):
                got = got.view(np.uint16)
            for i, fut in enumerate(futs):
                want = fut.result()
                if not np.array_equal(got[i], want):
                    raise AssertionError(f"Y {fmt} frame {i} differs from "
                                         "the scalar oracle")
                n_orc += 1
        log(f"Y: the first {n_oracle} frames of every format equal the "
            f"scalar oracle ({n_orc} frame-formats)")
        kern["Y"]["formats_ms"] = {f: kern["Y" if f == "rgb24" else
                                        f"Y {f}"]["ms"] for f in outs}
        kern["Y"]["ptxas"] = ptx.get("yuv2rgb_packed.cu", [])
        del outs, y, cb, cr

        # kernel W: both entries against their plain versions
        n_mcu = ((W + 15) // 16) * ((H + 15) // 16)
        nb = n_mcu * 6
        rows, lens = m.native.unescape_frames(pays)
        lv, ok = m.D.decode_scans(torch.from_numpy(rows).to(dev),
                                  torch.from_numpy(lens).to(dev), nb)
        assert bool(ok.all())
        lv = lv.view(n, n_mcu, 6, 64)
        in_b = n * nb * 128
        ops_w = n * nb * OPS_AMVLIB
        check("W planes", lambda: m.amvlib_video.decode_transform_amvlib(
            lv, W // 16, (H + 15) // 16, W, H),
            lambda: m.amvlib_video.decode_transform_amvlib_plain(
                lv, W // 16, (H + 15) // 16, W, H),
            f"{n} frames, the int32 planes", in_b + n * H * W * 6, ops_w)
        rgb_w = check("W", lambda: (m.amvlib_video.decode_rgb_amvlib(
            lv, W, H),), lambda: (m.amvlib_video.rgb_amvlib_plain(
                *m.amvlib_video.decode_transform_amvlib_plain(
                    lv, W // 16, (H + 15) // 16, W, H)),),
            f"{n} frames, the RGB entry", in_b + n * H * W * 3, ops_w)[0]
        for key, fn in (
                ("W", lambda: m.amvlib_video.decode_rgb_amvlib(lv, W, H)),
                ("W planes", lambda: m.amvlib_video.decode_transform_amvlib(
                    lv, W // 16, (H + 15) // 16, W, H))):
            kern[key]["device_ms"] = device_ms(fn, ("amvlib_idct",))
            kern[key]["burst_ms"] = burst_ms(fn)
        log(f"Y rgb24 device {kern['Y']['device_ms']} ms, bursts "
            f"{kern['Y']['burst_ms']:.4f} ms; W RGB device "
            f"{kern['W']['device_ms']} ms, bursts {kern['W']['burst_ms']:.4f}"
            f" ms; W planes device {kern['W planes']['device_ms']} ms, "
            f"bursts {kern['W planes']['burst_ms']:.4f} ms (torch.profiler; "
            "20 launches back to back between CUDA events)")
        kern["W"]["ptxas"] = ptx.get("amvlib_idct.cu", [])
        one = lv[:1].clone()
        kern["W"]["one_frame_ms"] = cuda_ms(
            lambda: m.amvlib_video.decode_rgb_amvlib(one, W, H), 20)[0]
        batch = m.amvlib_video.decode_frames_amvlib_rgb(pays, W, H,
                                                        device=dev)
        assert torch.equal(batch, rgb_w)
        del lv, rows, lens, one

        # the CLI routes, timed, then split by stage
        src = os.path.join(tmp, "corpus.amv")
        with open(src, "wb") as f:
            f.write(data)
        routes = (("pixel rgb24", ["-pix_fmt", "rgb24", "out.rgb"]),
                  ("pixel rgb565", ["-pix_fmt", "rgb565", "out.raw"]),
                  ("bmp bt601", ["--color", "bt601", "bt601/f_%04d.bmp"]),
                  ("bmp amvlib", ["--color", "amvlib", "amvlib/f_%04d.bmp"]))
        for key, argv in routes:
            argv = argv[:-1] + [os.path.join(tmp, argv[-1])]
            reset_launches(m)
            t0 = time.perf_counter()
            assert m.cli.main(["-i", src, *argv, "--device", dev.type]) == 0
            wall = time.perf_counter() - t0
            paths[key] = launches(m)
            assert paths[key]["D"] > 0 and paths[key]["U"] > 0
            assert (paths[key]["Y"] > 0) == key.startswith("pixel"), paths
            split = {}
            s = staged(split, "read + demux", lambda: m.riff.read(src))
            planes = staged(split, "device decode (D, U)", lambda: (
                m.amv_video.decode_frames_device(s.video_chunks, W, H,
                                                 device=dev)))
            if key.startswith("pixel"):
                fmt = argv[1]
                conv = staged(split, "device Y", lambda: (
                    m.Y.yuv420_to_packed(*planes, fmt=fmt)))
            else:
                conv = staged(split, "device color", lambda: (
                    m.color.yuv420_to_rgb(*planes, mode=argv[1])))
            hst = staged(split, "device->host", lambda: conv.cpu().numpy())
            if key.startswith("pixel"):
                with open(argv[-1], "rb") as f:
                    assert f.read() == hst.tobytes(), key
                staged(split, "write", lambda: open(
                    os.path.join(tmp, "again"), "wb").write(hst.tobytes()))
            else:
                d = os.path.dirname(argv[-1])
                with open(os.path.join(d, "f_0007.bmp"), "rb") as f:
                    first = f.read()
                staged(split, "write", lambda: [m.cli._write_bmp(
                    os.path.join(d, f"g_{i:04d}.bmp"), hst[i])
                    for i in range(n)])
                with open(os.path.join(d, "g_0007.bmp"), "rb") as f:
                    assert f.read() == first, key
                assert len(os.listdir(d)) == 2 * n
                shutil.rmtree(d)
            kern.setdefault("pixel cli", {})[key] = {
                "wall_s": wall, "frames_s": n / wall, "split_s": split}
            log(f"{card}: cli.main -i corpus.amv {' '.join(argv[:-1])} "
                f"{os.path.basename(argv[-1])}: {n} frames in {wall:.3f} s ="
                f" {n / wall:.1f} frames/s; launches {paths[key]}")
            log_split(key, split)
            del planes, conv, hst

        # the amvlib API, a frame a call
        amv = m.amvlib_api.AmvOpen(src, device=dev.type)
        assert amv is not None and amv.device.type == dev.type
        reset_launches(m)
        t0 = time.perf_counter()
        k = 0
        while True:
            assert m.amvlib_api.AmvReadNextFrame(amv) == 0
            if amv.framebuf.framenum < 0:
                break
            assert m.amvlib_api.AmvVideoDecode(amv) == 0
            if k < 64 and not np.array_equal(
                    amv.videobuf, batch[k].flip(0).flip(-1).cpu().numpy()):
                raise AssertionError(f"AmvVideoDecode frame {k} differs "
                                     "from the batch decode")
            k += 1
        sync()
        wall = time.perf_counter() - t0
        paths["amvlib api"] = launches(m)
        assert k == n and paths["amvlib api"]["W"] == n and \
            paths["amvlib api"]["D"] == n, paths["amvlib api"]
        m.amvlib_api.AmvClose(amv)
        kern["W"]["api"] = {"frames": n, "s": wall, "frames_s": n / wall}
        log(f"{card}: AmvOpen -> AmvReadNextFrame/AmvVideoDecode over {n} "
            f"frames on {dev.type}: {wall:.3f} s = {n / wall:.1f} frames/s "
            f"(a frame a call: D and W launched once each); the first "
            f"{min(64, n)} equal the batch decode; launches "
            f"{paths['amvlib api']}")
        del batch, rgb_w
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    log(f"phase 17 took {time.perf_counter() - t17:.1f} s")


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.device_count()} "
        f"device(s), using {torch.cuda.get_device_name(0)}")
    m = import_port()
    assert not [k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "amv_tpu")]
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 2. build ---------------------------------------------------
    t0 = time.perf_counter()
    ptxas = ptxas_start(m)
    m._build.library()
    m.native.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{' '.join(m._build.NVCC_FLAGS)}; host C library with gcc)")
    ptx = ptxas_log(m, ptxas)
    # G's listing with line information, for its floor in phase 15; nvcc
    # runs while the phases do
    pool = concurrent.futures.ThreadPoolExecutor(2)
    g_sass = pool.submit(m.tools_g.listing, m._build, "g729_decode.cu")
    k_libs = pool.submit(m.tools_g.k_libraries, m._build, {
        "baseline": (m.tools_g.K_BASELINE, False),
        "baseline phases": (m.tools_g.K_BASELINE, True),
        "tree phases": (os.path.join(m.tools_t._csrc(m._build),
                                     "g729_encode.cu"), True)})
    pool.shutdown(wait=False)
    t_sass = m.tools_t.sass_counts(m._build, ("transcode_blocks_kernel",))
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
        .split()[0])

    # ---- 3. corpus --------------------------------------------------
    t0 = time.perf_counter()
    pics = pictures(m, N_FRAMES, H, W, seed=0)
    pays = c_encode(m, pics)
    second = m.ref_adpcm.encode(m.fixtures.audiogen(1.0, RATE, seed=0),
                                round(RATE / FPS), RATE)
    audio = second * (N_FRAMES // FPS)
    data = m.riff.mux(pays, audio, width=W, height=H, fps=FPS,
                      sample_rate=RATE)
    pcm = m.fixtures.audiogen(N_FRAMES / FPS, RATE, seed=0)
    sizes = sorted(len(p) for p in pays)
    log(f"corpus: {N_FRAMES} frames {W}x{H} qscale {QSCALE}, payload bytes "
        f"min {sizes[0]} median {sizes[len(sizes) // 2]} max {sizes[-1]}; "
        f"{len(audio)} audio chunks; {len(data)} bytes; {len(pcm)} PCM "
        f"samples for the encode; {time.perf_counter() - t0:.1f} s")

    # ---- 4. kernels against their plain versions ---------------------
    # At the main paths' shapes; the outputs of each kernel's last timed
    # call are held against its plain version's, which runs once without a
    # warm-up (the plain decoder alone takes 15-20 s).
    n_mcu = ((W + 15) // 16) * ((H + 15) // 16)
    nb = n_mcu * 6
    qmat = m.amv_video.encoder_qmat(QSCALE)
    rows_all, lens_all = m.native.unescape_frames(pays)
    order = np.argsort([len(p) for p in pays], kind="stable")
    rows_a = torch.from_numpy(rows_all[order]).to(dev)
    lens_a = torch.from_numpy(lens_all[order]).to(dev)
    kern, errs = {}, {}

    def tokens(levels):
        """Huffman tokens of zigzag levels: nonzero ACs, DCs and EOBs."""
        return int((levels[..., 1:] != 0).sum()) + 2 * levels[..., 0].numel()

    def check(key, kernel, plain, shape, nbytes, ops):
        """Time kernel and plain, hold their outputs equal, and record the
        bound; nbytes and ops are numbers or functions of the output."""
        kt, got = cuda_ms(kernel, 10)
        pt, want = cuda_ms(plain, 1, warmup=False)
        errs[key] = max_abs_err(zip(got, want))
        assert errs[key] == 0, f"{key}: kernel differs from plain by {errs[key]}"
        nbytes, ops = (v(got) if callable(v) else v for v in (nbytes, ops))
        bms, by = bound(nbytes, ops)
        kern[key] = {"ms": kt, "plain_ms": pt, "bound_ms": bms,
                     "bound_by": by}
        log(f"{key} at {shape}: bit-exact vs plain (max_abs_err 0); kernel "
            f"{kt:.3f} ms, plain {pt:.3f} ms (median, CUDA events); bound "
            f"{bms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} G int ops)")
        return got

    def extra(key, pairs, what):
        errs[key] = max_abs_err(pairs)
        assert errs[key] == 0, f"{key}: kernel differs by {errs[key]}"
        log(f"{key}: bit-exact vs plain on {what}")

    lv_a, ok_a = check(
        "D", lambda: m.D.decode_scans(rows_a, lens_a, nb),
        lambda: m.D.decode_scans_plain(rows_a, lens_a, nb),
        f"rows {tuple(rows_a.shape)}",
        int(lens_a.sum()) + 8 * N_FRAMES + N_FRAMES * nb * 128 + N_FRAMES,
        lambda got: OPS_TOKEN * tokens(got[0]))
    assert ok_a.all()

    def log_rounds(key, rounds):
        rounds = rounds.float()
        kern[key]["rounds"] = {"mean": float(rounds.mean()),
                               "max": int(rounds.max())}
        log(f"{key} sync rounds after the speculation, per frame: mean "
            f"{float(rounds.mean()):.2f}, max {int(rounds.max())} "
            f"({int((rounds == 0).sum())} of {N_FRAMES} frames in step at "
            "once)")

    log_rounds("D", m.D.decode_scans(rows_a, lens_a, nb, rounds=True)[2])
    dc_a = m.amv_video.resolve_dc(
        lv_a.reshape(N_FRAMES, n_mcu, 6, 64)).reshape(-1)
    lvf = lv_a.reshape(-1, 64)
    n_blk = lvf.shape[0]
    geom = m.T._geometry((W, H), n_blk)
    check("T", lambda: (m.T.transcode_blocks(lvf, dc_a, qmat, (W, H)),),
          lambda: m.T.transcode_blocks_plain(lvf, dc_a, qmat, geom, False)[:1],
          f"{n_blk} blocks", n_blk * (128 + 4 + 128),
          n_blk * (OPS_DEQUANT + OPS_IDCT + OPS_FDCT))
    lv2_a, _ = check(
        "T pixel entry",
        lambda: m.T.transcode_blocks_pix(lvf, dc_a, qmat, (W, H)),
        lambda: m.T.transcode_blocks_plain(lvf, dc_a, qmat, geom, True),
        f"{n_blk} blocks", n_blk * (128 + 4 + 128 + 64),
        n_blk * (OPS_DEQUANT + OPS_IDCT + OPS_FDCT))
    lv2_a = lv2_a.reshape(lv_a.shape)
    wb = m.P.word_budget(rows_a)
    # E as the path runs it (pack_levels): the count entry, then the pack
    # at the longest frame's words
    (bits_c,) = check(
        "E count", lambda: (m.E.count_bits(lv2_a),),
        lambda: (m.E.count_bits_plain(lv2_a),), f"levels {tuple(lv2_a.shape)}",
        n_blk * 128 + 4 * N_FRAMES, OPS_TOKEN * tokens(lv2_a))
    w_used = (int(bits_c.max()) + 31) // 32
    words_e, bits_e, ok_e = check(
        "E", lambda: m.E.encode_levels(lv2_a, w_used),
        lambda: m.E.encode_levels_plain(lv2_a, w_used),
        f"levels {tuple(lv2_a.shape)}, w_out {w_used}",
        n_blk * 128 + N_FRAMES * (4 * w_used + 5), OPS_TOKEN * tokens(lv2_a))
    assert ok_e.all() and torch.equal(bits_e, bits_c)
    (pix_i,) = check(
        "I", lambda: (m.idct.idct_blocks(lvf, dc_a),),
        lambda: (m.idct.idct_blocks_plain(lvf, dc_a),),
        f"{n_blk} blocks", n_blk * (128 + 4 + 64),
        n_blk * (OPS_DEQUANT + OPS_IDCT))
    # I's raw entry (idct_put_soa's contract) on the corpus's own
    # dequantized blocks
    deq = m.idct.dequantize(lvf, dc_a).to(torch.int16)
    check("I idct_put", lambda: (m.idct.idct_put(deq.view(-1, 8, 8)),),
          lambda: (m.idct.idct_put_plain(deq).view(-1, 8, 8),),
          f"{n_blk} dequantized blocks", n_blk * (128 + 64),
          n_blk * OPS_IDCT)
    # T's dequantized entry (transcode_soa's contract) on the same blocks
    check("T deq entry", lambda: m.T.transcode_deq(deq, qmat),
          lambda: m.T.transcode_deq_plain(deq, qmat),
          f"{n_blk} dequantized blocks", n_blk * (128 + 64 + 128),
          n_blk * (OPS_IDCT + OPS_FDCT))
    # T's wrap (transcode_zz_wrap's contract): the first N_CHECK frames'
    # blocks WRAP times over, each output block with its base block's DC;
    # the plain version runs in slices of whole MCUs
    base = lvf[:N_CHECK * nb]
    n_wrap = base.shape[0] * WRAP
    widx = m.T.wrap_index(base.shape[0], WRAP, device=dev)
    dc_wrap = dc_a[:base.shape[0]][widx]
    step = 6 << 18

    def wrap_plain():
        outs = [m.T.transcode_blocks_plain(base[widx[a:a + step]],
                                           dc_wrap[a:a + step], qmat)
                for a in range(0, n_wrap, step)]
        return tuple(torch.cat(o) for o in zip(*outs))

    check("T wrap", lambda: m.T.transcode_blocks_pix(base, dc_wrap, qmat,
                                                     repeat=WRAP),
          wrap_plain, f"repeat={WRAP} over {base.shape[0]} blocks, {n_wrap} "
          "blocks out", base.shape[0] * 128 + n_wrap * (4 + 128 + 64),
          n_wrap * (OPS_DEQUANT + OPS_IDCT + OPS_FDCT))
    del widx, dc_wrap
    # kernel T's static SASS count a block, and for each entry a static-count
    # estimate of its issue time at its own blocks (an upper bound on the
    # issue of its instructions: the count holds both sides of each branch)
    t_entries = {"zigzag": ("T", n_blk),
                 "zigzag pix": ("T pixel entry", n_blk),
                 "deq pix": ("T deq entry", n_blk),
                 "wrap pix": ("T wrap", n_wrap)}
    sass_t = {}
    for fn, (cnt, ops) in sorted(t_sass.items()):
        entry = m.tools_t.t_instance(fn)
        sass_t[entry] = cnt
        key, blocks = t_entries[entry]
        log(f"T SASS {entry}: {cnt} instructions a block (static); "
            f"static-count issue estimate at its {blocks} blocks "
            f"<= {m.tools_t.issue_ms(cnt, blocks, max_mhz):.4f} ms "
            f"({max_mhz:.0f} MHz) beside its byte bound "
            f"{kern[key]['bound_ms']:.4f} ms and its time "
            f"{kern[key]['ms']:.4f} ms; commonest "
            + ", ".join(f"{o} {c}" for o, c in ops))
    # R and X: the record decode of the transcode's scans in a budget no
    # frame overflows (a block owns at most 64 records), then R + X against
    # kernel D's levels
    t_rec = 64 * nb
    recs_a, st_a = check(
        "R", lambda: m.R.decode_records(rows_a, lens_a, nb, t_rec),
        lambda: m.R.decode_records_plain(rows_a, lens_a, nb, t_rec),
        f"rows {tuple(rows_a.shape)}, {m.R.record_rows(t_rec)} records a "
        "frame", lambda got: int(lens_a.sum()) + 8 * N_FRAMES +
        4 * got[0].numel() + 8 * N_FRAMES,
        lambda got: OPS_TOKEN * int(got[1][:, 1].sum()))
    assert (st_a[:, 0] == nb).all() and recs_a.is_contiguous()
    log_rounds("R", m.R.decode_records(rows_a, lens_a, nb, t_rec,
                                       rounds=True)[2])
    cnt_a = st_a[:, 1].contiguous()
    n_dec = int(cnt_a.sum())
    (lv_x,) = check(
        "X", lambda: (m.R.expand_records(recs_a, cnt_a, nb),),
        lambda: (m.R.expand_records_plain(recs_a, cnt_a, nb),),
        f"records {tuple(recs_a.shape)}, {n_dec} used",
        4 * n_dec + 4 * N_FRAMES + N_FRAMES * nb * 128, OPS_SCATTER * n_dec)
    extra("R+X", [(lv_x, lv_a)], f"{N_FRAMES} frames: kernel D's levels "
          f"({int(st_a[:, 1].sum())} records, at most "
          f"{int(st_a[:, 1].max())} a frame)")
    del recs_a, lv_x
    # P on the record encoder's records of the re-encode levels, and its
    # words against kernel E's
    recs_p, tot_p, _, ok_p = m.R.tokenize_levels(lv2_a, t_rec)
    assert ok_p.all()
    n_rec = int(tot_p.sum())
    words_p, bits_p = check(
        "P", lambda: m.RP.pack_records(recs_p, tot_p, wb),
        lambda: m.RP.pack_records_plain(recs_p, tot_p, wb),
        f"records {tuple(recs_p.shape)}, w_out {wb}",
        lambda got: 4 * n_rec + 4 * N_FRAMES + N_FRAMES * (
            4 * ((int(got[1].max()) + 31) // 32) + 4), OPS_RECORD * n_rec)
    assert not words_p[:, w_used:].any()
    extra("P vs E", [(words_p[:, :w_used], words_e), (bits_p, bits_e)],
          f"{N_FRAMES} frames ({n_rec} records): kernel E's words and bits")
    del lv2_a, words_e, pix_i, deq, words_p
    ysrc = [torch.from_numpy(p).to(dev) for p in pics]
    blocks = m.amv_video.extract_blocks(*ysrc, (W + 15) // 16,
                                        (H + 15) // 16).reshape(-1, 64)
    check("F", lambda: (m.fdct.fdct_quant_blocks(blocks, qmat),),
          lambda: (m.fdct.fdct_quantize_plain(blocks, qmat)[
              :, torch.as_tensor(m.jpeg_tables.ZIGZAG,
                                 device=dev).long()],),
          f"{blocks.shape[0]} extracted blocks", blocks.shape[0] * (64 + 128),
          blocks.shape[0] * OPS_FDCT)
    check("F raster", lambda: (m.fdct.fdct_quantize(blocks.view(-1, 8, 8),
                                                    qmat),),
          lambda: (m.fdct.fdct_quantize_plain(blocks, qmat),),
          f"{blocks.shape[0]} extracted blocks (fdct_quantize's contract)",
          blocks.shape[0] * (64 + 128), blocks.shape[0] * OPS_FDCT)
    # U: the decode path's entry on the corpus levels and DC, un-sorting the
    # length-sorted batch as decode_frames does (8 bytes of dst a frame);
    # its contract entry on the same levels in raster order
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    plane_bytes = N_FRAMES * W * H * 3 // 2
    coded_bytes = N_FRAMES * n_mcu * 384             # 256 Y + 64 Cb + 64 Cr
    order_t = torch.from_numpy(order).to(dev)
    check("U", lambda: m.U.decode_planes(lvf, dc_a, W, H, dst=order_t),
          lambda: m.U.decode_planes_plain(lvf, dc_a, W, H, order_t),
          f"{n_blk} blocks -> {N_FRAMES} display frames {W}x{H}",
          n_blk * (128 + 4) + 8 * N_FRAMES + plane_bytes,
          n_blk * (OPS_DEQUANT + OPS_IDCT))
    zz = torch.as_tensor(m.jpeg_tables.ZIGZAG, device=dev).long()
    lv_ras = torch.empty_like(lvf)
    lv_ras[:, zz] = lvf
    lv_ras = lv_ras.view(N_FRAMES, n_mcu, 6, 64)
    dc4 = dc_a.view(N_FRAMES, n_mcu, 6)
    check("U coded", lambda: m.U.decode_fused(lv_ras, dc4, mb_w, mb_h),
          lambda: m.U.decode_fused_plain(lv_ras, dc4, mb_w, mb_h),
          f"{n_blk} raster blocks -> coded planes (decode_fused's contract)",
          n_blk * (128 + 4) + coded_bytes, n_blk * (OPS_DEQUANT + OPS_IDCT))
    del lv_ras
    # V: the encode path's entry on the raw corpus pictures with each
    # quantizer; its contract entry on their coded (flipped, padded) planes
    check("V", lambda: (m.V.encode_planes(*ysrc, QSCALE),),
          lambda: (m.V.encode_planes_plain(*ysrc, qmat),),
          f"{N_FRAMES} display frames {W}x{H} -> {n_blk} blocks, ffmpeg",
          plane_bytes + n_blk * 128, n_blk * OPS_FDCT)
    check("V q60", lambda: (m.V.encode_planes(*ysrc, QSCALE, "q60"),),
          lambda: (m.V.encode_planes_plain(*ysrc, qmat, "q60"),),
          f"{N_FRAMES} display frames {W}x{H} -> {n_blk} blocks, q60",
          plane_bytes + n_blk * 128, n_blk * OPS_FDCT_Q60)
    coded = [p.contiguous() for p in m.U.coded_planes(
        blocks.view(N_FRAMES, n_mcu, 6, 8, 8), mb_w, mb_h)]
    check("V coded", lambda: (m.V.encode_fused(*coded, mb_w, mb_h, QSCALE),),
          lambda: (m.V.encode_fused_plain(*coded, mb_w, mb_h, qmat),),
          f"coded planes of {N_FRAMES} frames (encode_fused's contract)",
          coded_bytes + n_blk * 128, n_blk * OPS_FDCT)
    pay_np, pred_np, sidx_np, alens = m.amv_audio.chunk_arrays(audio)
    pay_t, pred_t, sidx_t = (torch.from_numpy(a).to(dev)
                             for a in (pay_np, pred_np, sidx_np))
    c_a, nby = pay_t.shape
    check("A", lambda: (m.adpcm.decode_chunks(pay_t, pred_t, sidx_t),),
          lambda: (m.adpcm.decode_chunks_plain(pay_t, pred_t, sidx_t),),
          f"{c_a} chunks x {nby} bytes", c_a * (nby + 8 + 4 * nby),
          c_a * 2 * nby * OPS_EXPAND)
    wrap_samples = c_a * WRAP * 2 * nby
    check("A wrap", lambda: (m.adpcm.decode_chunks(pay_t, pred_t, sidx_t,
                                                   repeat=WRAP),),
          lambda: (m.adpcm.decode_chunks_plain(pay_t, pred_t, sidx_t,
                                               repeat=WRAP),),
          f"repeat={WRAP}, {wrap_samples} samples",
          c_a * (nby + 8) + 2 * wrap_samples, wrap_samples * OPS_EXPAND)
    log(f"A wrap: {wrap_samples / kern['A wrap']['ms'] / 1e3:.1f} "
        "Msamples/s (median, CUDA events)")
    frame_size = m.encode.av_rescale_near(RATE, 1, FPS)
    ns, starts, padded, reset = m.amv_audio.stream_layout(pcm, frame_size,
                                                          RATE)
    x_q = torch.from_numpy(padded[None]).to(dev)
    r_q = torch.from_numpy(reset[None]).to(dev)
    s_q = torch.zeros(1, dtype=torch.int32, device=dev)
    n_q = padded.shape[0]
    check("Q", lambda: m.adpcm.encode_streams(x_q, r_q, s_q),
          lambda: m.adpcm.encode_streams_plain(x_q, r_q, s_q),
          f"1 stream x {n_q} samples, {len(ns)} chunks",
          2 * n_q + n_q + 4 + n_q, n_q * OPS_COMPRESS)
    check("Q wrap", lambda: m.adpcm.encode_streams(x_q, r_q, s_q,
                                                   repeat=Q_WRAP),
          lambda: m.adpcm.encode_streams_plain(x_q, r_q, s_q, repeat=Q_WRAP),
          f"repeat={Q_WRAP}, {Q_WRAP * n_q} samples",
          2 * n_q + n_q + 4 + Q_WRAP * n_q, Q_WRAP * n_q * OPS_COMPRESS)
    # Q's passes on the stream, and one chunk alone (one segment: the
    # latency of one serial walk, which sets Q's floor, not its bytes)
    n1 = 2 * ns[0]
    x1, r1 = x_q[:, :n1], r_q[:, :n1]
    kern["Q"]["passes_ms"] = q_passes(
        lambda: m.adpcm.encode_streams(x_q, r_q, s_q))
    kern["Q"]["one_chunk_ms"] = cuda_ms(
        lambda: m.adpcm.encode_streams(x1, r1, s_q), 10)[0]
    one = q_passes(lambda: m.adpcm.encode_streams(x1, r1, s_q))
    log("Q passes at 1 stream x {} samples (device ms a call, "
        "torch.profiler): {}; one chunk of {} samples alone {:.4f} ms "
        "(passes {}) beside the stream's byte bound {:.4f} ms".format(
            n_q, ", ".join(f"{k} {v:.4f}" for k, v in
                           kern["Q"]["passes_ms"].items()), n1,
            kern["Q"]["one_chunk_ms"], ", ".join(
                f"{k} {v:.4f}" for k, v in one.items()),
            kern["Q"]["bound_ms"]))
    log(f"V at {N_FRAMES} frames {W}x{H}: ffmpeg {kern['V']['ms']:.3f} ms, "
        f"q60 {kern['V q60']['ms']:.3f} ms, contract entry "
        f"{kern['V coded']['ms']:.3f} ms (median, CUDA events)")

    # extra cases on N_CHECK corpus frames: malformed scans for D, T without
    # edge replication, E with a word budget every frame overflows, I on
    # DC-only blocks, F at qscale 1
    rng = np.random.default_rng(1)
    rows, lens = m.native.unescape_frames(pays[:N_CHECK])
    bad = rows[:8].copy()
    bad_lens = lens[:8].copy()
    bad[0] = rng.integers(0, 256, bad.shape[1])            # random bytes
    bad[1, 100:108] = 0xFF                                 # invalid code
    bad_lens[2] //= 3                                      # truncated
    bad_lens[3] = 0                                        # empty
    bad[4, 7::97] = rng.integers(0, 256, len(bad[4, 7::97]))
    rows_t = torch.from_numpy(np.concatenate([rows, bad])).to(dev)
    lens_t = torch.from_numpy(np.concatenate([lens, bad_lens])).to(dev)
    lv_k, ok_k = m.D.decode_scans(rows_t, lens_t, nb)
    lv_p, ok_p = m.D.decode_scans_plain(rows_t, lens_t, nb)
    extra("D extra", [(lv_k, lv_p), (ok_k, ok_p)],
          f"{N_CHECK} frames + 8 malformed (ok {ok_k[N_CHECK:].tolist()})")
    assert ok_k[:N_CHECK].all() and not ok_k[N_CHECK + 1], ok_k[N_CHECK:]
    cases = d_cases(m, rows[:N_PAD], lens[:N_PAD], nb, rng)
    # the plain decoder loops to the longest frame whatever the batch, so
    # the cases at the corpus's stride share one plain call (each its own
    # kernel launch)
    flat = [c for c in cases if c[1].shape[1] == rows.shape[1]]
    lv_f, ok_f = m.D.decode_scans_plain(
        torch.from_numpy(np.concatenate([c[1] for c in flat])).to(dev),
        torch.from_numpy(np.concatenate([c[2] for c in flat])).to(dev), nb,
        budget=torch.cat([m.D.token_budget(torch.from_numpy(c[2]), nb,
                                           rows.shape[1]) if c[3] is None
                          else c[3] for c in flat]).to(dev))
    plain_of = {c[0]: (lv_f[i * N_PAD:(i + 1) * N_PAD],
                       ok_f[i * N_PAD:(i + 1) * N_PAD])
                for i, c in enumerate(flat)}
    del lv_f, ok_f
    for name, r_c, l_c, b_c in cases:
        rt_c = torch.from_numpy(r_c).to(dev)
        lt_c = torch.from_numpy(l_c).to(dev)
        kw = {} if b_c is None else {"budget": b_c.to(dev)}
        *got, rounds_c = m.D.decode_scans(rt_c, lt_c, nb, rounds=True, **kw)
        want = plain_of.get(name) or m.D.decode_scans_plain(rt_c, lt_c, nb,
                                                            **kw)
        extra(f"D {name}", zip(got, want),
              f"{N_PAD} corpus scans, {name} (ok {int(got[1].sum())} of "
              f"{N_PAD}; sync rounds max {int(rounds_c.max())})")
        if name.startswith("fail") or name == "budget":
            assert not got[1][::2].any() and got[1][1::2].all(), name
    t_def = m.R.default_t_max(nb, rows_t.shape[1])
    rec_k = m.R.decode_records(rows_t, lens_t, nb, t_def)
    rec_p = m.R.decode_records_plain(rows_t, lens_t, nb, t_def)
    extra("R extra", zip(rec_k, rec_p),
          f"{N_CHECK} frames + 8 malformed in JAX's default budget of "
          f"{t_def} records ({int((rec_k[1][:, 0] < nb).sum())} frames not "
          "done)")
    extra("X extra", [(m.R.expand_records(rec_k[0], rec_k[1][:, 1]
                                          .contiguous(), nb),
                       m.R.expand_records_plain(rec_p[0], rec_p[1][:, 1], nb))],
          "those records")
    extra("P extra", zip(m.RP.pack_records(recs_p[:N_CHECK],
                                           tot_p[:N_CHECK], 16),
                         m.RP.pack_records_plain(recs_p[:N_CHECK],
                                                 tot_p[:N_CHECK], 16)),
          f"{N_CHECK} frames at w_out 16 (every frame overflows)")
    del rec_k, rec_p, recs_p

    lv = lv_k[:N_CHECK].reshape(-1, 64)
    dc = m.amv_video.resolve_dc(
        lv_k[:N_CHECK].reshape(N_CHECK, n_mcu, 6, 64)).reshape(-1)
    want_lv, want_pix = m.T.transcode_blocks_plain(
        lv, dc, qmat, m.T._geometry(None, lv.shape[0]))
    got_lv, got_pix = m.T.transcode_blocks_pix(lv, dc, qmat, None)
    got_lv2 = m.T.transcode_blocks(lv, dc, qmat, None)
    extra("T extra", [(got_lv, want_lv), (got_pix, want_pix),
                      (got_lv2, want_lv)],
          f"{lv.shape[0]} blocks, both entries, without edge replication")

    lv2 = m.T.transcode_blocks(lv, dc, qmat, (W, H)).reshape(N_CHECK, nb, 64)
    got = m.E.encode_levels(lv2, 16)
    extra("E extra", zip(got, m.E.encode_levels_plain(lv2, 16)),
          f"{N_CHECK} frames at w_out 16 (every frame overflows, ok = 0)")
    assert not got[2].any(), "a 16-word budget must overflow"
    for target in (0, 1):
        lv_f, bits_f = e_fit(m, lv2[:8], target)
        pairs = []
        for w_out in (bits_f // 32, bits_f // 32 + 1):
            got = m.E.encode_levels(lv_f, w_out)
            pairs += zip(got, m.E.encode_levels_plain(lv_f, w_out))
            assert bool(got[2][0]) == (target == 0 or w_out > bits_f // 32)
        extra("E fit", pairs, f"a frame of {bits_f} bits at w_out "
              f"{bits_f // 32} and {bits_f // 32 + 1}")
    got = m.E.encode_levels(lv2[:N_PAD], 30000)
    extra("E unstaged", zip(got, m.E.encode_levels_plain(lv2[:N_PAD],
                                                         30000)),
          f"{N_PAD} frames at w_out 30,000 (120 KB: words ORed in device "
          "memory)")

    lv_dc = lv.clone()
    lv_dc[:, 1:] = 0
    extra("I extra", [(m.idct.idct_blocks(lv_dc, dc),
                       m.idct.idct_blocks_plain(lv_dc, dc)),
                      (m.idct.idct_put(lv.reshape(-1, 8, 8)),
                       m.idct.idct_put_plain(lv).reshape(-1, 8, 8))],
          f"{lv.shape[0]} DC-only blocks, and the raw idct_put entry")
    q1 = m.amv_video.encoder_qmat(1)
    fb = blocks[:N_CHECK * nb]
    extra("F extra", [(m.fdct.fdct_quantize(fb.reshape(-1, 8, 8), q1),
                       m.fdct.fdct_quantize_plain(fb, q1))],
          f"{fb.shape[0]} blocks at qscale 1 (wrapping products), raster "
          "entry")
    del blocks, fb
    fp = [p[:N_CHECK] for p in ysrc]
    extra("V extra", [(m.V.encode_planes(*fp, 1), m.V.encode_planes_plain(
        *fp, q1)), (m.V.encode_fused(*(c[:N_CHECK] for c in coded), mb_w,
                                     mb_h, 1),
                     m.V.encode_fused_plain(*(c[:N_CHECK] for c in coded),
                                            mb_w, mb_h, q1))],
          f"{N_CHECK} frames at qscale 1, both entries")
    del coded, fp
    flat = []
    for val in (0, 255, 128, 13):
        fl = [torch.full((16, hh, ww), v, dtype=torch.uint8, device=dev)
              for (hh, ww), v in (((H, W), val), ((H // 2, W // 2), 255 - val),
                                  ((H // 2, W // 2), val))]
        flat.append((m.V.encode_planes(*fl, QSCALE, "q60"),
                     m.V.encode_planes_plain(*fl, qmat, "q60")))
    extra("V q60 flat", flat, "16 flat frames at each of luma 0, 255, 128 "
          "and 13 under q60 (the DC chain at the clip rails)")
    for sw, sh in ((W_PAD, H), (ODD_W, ODD_H)):
        smw, smh = (sw + 15) // 16, (sh + 15) // 16
        n_s = N_PAD * smw * smh * 6
        lv_s = torch.from_numpy(rand_levels(rng, n_s)).to(dev)
        dc_s = torch.from_numpy(rng.integers(-40000, 40000, n_s)
                                .astype(np.int32)).to(dev)
        perm = torch.from_numpy(rng.permutation(N_PAD)).to(dev)
        pairs = list(zip(m.U.decode_planes(lv_s, dc_s, sw, sh, dst=perm),
                         m.U.decode_planes_plain(lv_s, dc_s, sw, sh, perm)))
        lv4, dc3 = lv_s.view(N_PAD, -1, 6, 64), dc_s.view(N_PAD, -1, 6)
        pairs += list(zip(m.U.decode_fused(lv4, dc3, smw, smh),
                          m.U.decode_fused_plain(lv4, dc3, smw, smh)))
        extra(f"U {sw}x{sh}", pairs, f"{N_PAD} frames of random levels, "
              "both entries")
        if m.T.takes_size((sw, sh)):
            geom_s = m.T._geometry((sw, sh), n_s)
            want = m.T.transcode_blocks_plain(lv_s, dc_s, qmat, geom_s)
            extra(f"T {sw}x{sh}", list(zip(
                m.T.transcode_blocks_pix(lv_s, dc_s, qmat, (sw, sh)), want))
                + [(m.T.transcode_blocks(lv_s, dc_s, qmat, (sw, sh)),
                    want[0])], f"{N_PAD} frames of random levels, both "
                  "entries (pad columns and rows)")
        ps = [torch.from_numpy(p).to(dev)
              for p in pictures(m, N_PAD, sh, sw, seed=sw)]
        cs = [p.contiguous() for p in m.U.coded_planes(m.V.extract_blocks(
            *ps, smw, smh), smw, smh)]
        extra(f"V {sw}x{sh}", [
            (m.V.encode_planes(*ps, QSCALE), m.V.encode_planes_plain(
                *ps, qmat)),
            (m.V.encode_planes(*ps, QSCALE, "q60"),
             m.V.encode_planes_plain(*ps, qmat, "q60")),
            (m.V.encode_fused(*cs, smw, smh, QSCALE),
             m.V.encode_fused_plain(*cs, smw, smh, qmat))],
            f"{N_PAD} pictures, both quantizers and the contract entry")
    lv_e = [torch.cat([k for k, _ in flat])]
    for sw, sh in ((320, 240), (ODD_W, ODD_H)):
        lv_e.append(m.V.encode_planes(*(torch.from_numpy(p).to(dev) for p in
                                        pictures(m, N_PAD, sh, sw, seed=sh)),
                                      QSCALE))
    pairs = []
    for lv_s in lv_e:
        bits_s = m.E.count_bits(lv_s)
        w_s = (int(bits_s.max()) + 31) // 32
        pairs += [(bits_s, m.E.count_bits_plain(lv_s))]
        pairs += zip(m.E.encode_levels(lv_s, w_s),
                     m.E.encode_levels_plain(lv_s, w_s))
    extra("E sizes", pairs, "the q60 flat frames, 320x240 and "
          f"{ODD_W}x{ODD_H} pictures, count and pack at the exact budget")
    del flat, lv_s, dc_s, lv4, dc3, ps, cs, lv_e
    stress = []
    for byte, sidx in ((0x77, sidx_t), (0xFF, torch.full_like(sidx_t, 88)),
                       (0x88, sidx_t)):
        p_s = torch.full_like(pay_t, byte)
        stress.append((m.adpcm.decode_chunks(p_s, pred_t, sidx),
                       m.adpcm.decode_chunks_plain(p_s, pred_t, sidx)))
    extra("A extra", stress, f"{c_a} chunks of all 0x77, of all 0xFF at "
          "step index 88, and of all 0x88 (clamp stress)")
    n10 = 2 * sum(ns[:160])                    # the first 10 s of chunks
    x10, r10 = x_q[:, :n10], r_q[:, :n10].clone()
    r10[:, 0] = False
    pairs = list(zip(m.adpcm.encode_streams(x10, r10, s_q),
                     m.adpcm.encode_streams_plain(x10, r10, s_q)))
    s88 = torch.full_like(s_q, 88)
    pairs += list(zip(m.adpcm.encode_streams(x10, r_q[:, :n10], s88),
                      m.adpcm.encode_streams_plain(x10, r_q[:, :n10], s88)))
    n2 = 2 * sum(ns[:32])                      # 2 s as one segment
    r2 = torch.zeros_like(r_q[:, :n2])
    r2[:, 0] = True
    pairs += list(zip(m.adpcm.encode_streams(x_q[:, :n2], r2, s_q),
                      m.adpcm.encode_streams_plain(x_q[:, :n2], r2, s_q)))
    extra("Q extra", pairs, f"{n10} samples with no reset at sample 0, and "
          f"from step index 88; {n2} samples as one segment")
    del lv_a, lvf, dc_a, ok_a, ysrc, x_q, r_q, stress, pairs
    torch.cuda.empty_cache()
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    paths = {}
    # ---- 17. pixel outputs and amvlib (on the corpus, after 4) ---------
    with tempfile.TemporaryDirectory() as tmp:
        pixel_phase(m, dev, paths, smi, check, extra, kern, data, pays,
                    tmp, ptx)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 5. the transcode through the CLI -------------------------
        want = c_transcode(m, pays, W, H)
        src, dst = os.path.join(tmp, "in.amv"), os.path.join(tmp, "out.amv")
        with open(src, "wb") as f:
            f.write(data)
        m.P.transcode_bytes(data, qscale=QSCALE, device="cuda")   # warm-up
        torch.cuda.synchronize()
        reset_launches(m)
        wall, walls = timed_cli(m, ["-i", src, "-f", "amv", dst,
                                    "--device", "cuda"])
        paths["transcode"] = launches(m)
        with open(dst, "rb") as f:
            out = m.riff.demux(f.read())
        assert out.video_chunks == want, "video differs from the C reference"
        ff_bytes = {"encode": sum(map(len, pays)),
                    "transcode": sum(map(len, want))}
        assert out.audio_chunks == audio, "audio did not pass through"
        assert all(paths["transcode"][k] > 0 for k in "DTE"), paths
        log(f"transcode: cli.main x3, {N_FRAMES} frames in "
            f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s"
            f" = {N_FRAMES / wall:.1f} frames/s; byte-identical to the C "
            f"reference, audio passed through; launches {paths['transcode']}")
        split = {}
        s = staged(split, "demux", lambda: m.riff.demux(data))
        rows_s, lens_s = staged(split, "unescape", lambda: (
            m.native.unescape_frames(s.video_chunks)))
        order = staged(split, "sort", lambda: np.argsort(
            np.array([len(p) for p in s.video_chunks]), kind="stable"))
        r_t, l_t = staged(split, "to_device", lambda: (
            torch.from_numpy(rows_s[order]).to(dev),
            torch.from_numpy(lens_s[order]).to(dev)))
        words, bits, ok = staged(split, "device_chain", lambda: (
            m.P.transcode_complete(r_t, l_t, n_mcu, QSCALE, (W, H))))
        inv = np.argsort(order)
        w_np, b_np = staged(split, "to_host", lambda: (
            words.cpu().numpy()[inv], bits.cpu().numpy()[inv]))
        vch = staged(split, "escape", lambda: m.native.escape_frames(
            w_np, b_np))
        staged(split, "mux", lambda: m.riff.mux(
            vch, s.audio_chunks, width=W, height=H, fps=FPS,
            sample_rate=RATE))
        assert vch == want
        log_split("transcode", split,
                  f"; words copied to the host {tuple(words.shape)}")

        # ---- 5b. the record decode, and the transcode's encoders -------
        torch.cuda.synchronize()
        reset_launches(m)
        lv_r, ok_r = m.R.decode_scans_async(r_t, l_t, nb, t_rec)
        torch.cuda.synchronize()
        paths["record decode"] = launches(m)
        lv_d, _ = m.D.decode_scans(r_t, l_t, nb)
        assert ok_r.all() and torch.equal(lv_r, lv_d)
        assert all(paths["record decode"][k] > 0 for k in "RX"), paths
        lv_def, ok_def = m.R.decode_scans_async(r_t, l_t, nb)
        good = ok_def.bool()
        assert torch.equal(lv_def[good], lv_d[good])
        log(f"record decode: decode_scans_async over {N_FRAMES} frames in a "
            f"budget of {t_rec} records a frame: levels equal to kernel D's;"
            f" in JAX's default budget ({m.R.default_t_max(nb, r_t.shape[1])}"
            f") {int((~good).sum())} frames run out (ok 0) and the rest "
            f"equal D's; launches {paths['record decode']}")
        del lv_r, lv_d, lv_def
        chain = {enc: [] for enc in m.P.ENCODERS}
        for enc in m.P.ENCODERS:                 # counted, and the warm-up
            reset_launches(m)
            words, bits, ok = m.P.transcode_complete(r_t, l_t, n_mcu, QSCALE,
                                                     (W, H), enc=enc)
            torch.cuda.synchronize()
            paths[f"transcode {enc}"] = launches(m)
            assert ok.all()
            assert m.native.escape_frames(words.cpu().numpy()[inv],
                                          bits.cpu().numpy()[inv]) == want, \
                f"enc={enc}: bytes differ from the C reference"
        for _ in range(3):                   # interleaved passes
            for enc in m.P.ENCODERS:
                t0 = time.perf_counter()
                m.P.transcode_complete(r_t, l_t, n_mcu, QSCALE, (W, H),
                                       enc=enc)
                torch.cuda.synchronize()
                chain[enc].append(time.perf_counter() - t0)
        for enc in m.P.ENCODERS[1:]:
            got = paths[f"transcode {enc}"]
            assert got["E"] == 0 and got["D"] > 0 and got["T"] > 0, (enc, got)
            assert (got["P"] > 0) == (enc != "parallel"), (enc, got)
        log("transcode device chain by entropy encoder (transcode_complete, "
            f"{N_FRAMES} frames, median of 3 interleaved passes, host clock "
            "after a synchronize): " + ", ".join(
                f"{enc} {statistics.median(chain[enc]) * 1e3:.1f} ms" for enc
                in m.P.ENCODERS) + "; every encoder's bytes equal the C "
            "reference; launches " + "; ".join(
                f"{enc} {paths[f'transcode {enc}']}" for enc in m.P.ENCODERS))
        # the encoders alone on the chain's re-encode levels, and the torch
        # stages of the record routes (median of 3, CUDA events)
        lv_c, _ = m.D.decode_scans(r_t, l_t, nb)
        dc_c = m.amv_video.resolve_dc(lv_c.reshape(-1, n_mcu, 6, 64))
        lv2_c = m.T.transcode_blocks(lv_c.reshape(-1, 64), dc_c.reshape(-1),
                                     qmat, (W, H)).reshape(lv_c.shape)
        wb_c = m.P.word_budget(r_t)
        stage = {f"encode_route {enc}": cuda_ms(
            lambda: m.P.encode_route(lv2_c, wb_c, enc), 3)[0]
            for enc in m.P.ENCODERS}
        stage["tokenize_levels"] = cuda_ms(
            lambda: m.R.tokenize_levels(lv2_c, t_rec), 3)[0]
        stage["rechunk_records"] = cuda_ms(
            lambda: m.EP.rechunk_records(lv2_c, None), 3)[0]
        def slot_pass():
            for a, b in m.EP.frame_chunks(N_FRAMES, nb):
                m.EP.slot_records(lv2_c[a:b])

        stage["slot_records"] = cuda_ms(slot_pass, 3)[0]
        log("encoders alone on the re-encode levels (median of 3, CUDA "
            "events): " + ", ".join(f"{k} {v:.2f} ms"
                                    for k, v in stage.items()))
        del lv_c, dc_c, lv2_c
        want_c = want                   # phase 11 serves the corpus again
        del want, words, r_t, l_t

        # ---- 6. the decode through the CLI ----------------------------
        yuv, wavp = os.path.join(tmp, "out.yuv"), os.path.join(tmp, "out.wav")
        m.decode.decode_bytes(data, device="cuda")                  # warm-up
        torch.cuda.synchronize()
        reset_launches(m)
        wall_v, walls_v = timed_cli(m, ["-i", src, yuv, "--device", "cuda"])
        paths["decode video"] = launches(m)
        reset_launches(m)
        wall_a, walls_a = timed_cli(m, ["-i", src, wavp, "--device", "cuda"])
        paths["decode audio"] = launches(m)
        assert paths["decode video"]["D"] > 0 and \
            paths["decode video"]["U"] > 0 and \
            paths["decode video"]["I"] == 0, paths
        assert paths["decode audio"]["A"] > 0, paths
        fbytes = W * H * 3 // 2
        raw = np.fromfile(yuv, np.uint8).reshape(N_FRAMES, fbytes)
        c_decode_matches(m, pays, W, H,
                         raw[:, :W * H].reshape(-1, H, W),
                         raw[:, W * H:W * H * 5 // 4].reshape(-1, H // 2, W // 2),
                         raw[:, W * H * 5 // 4:].reshape(-1, H // 2, W // 2))
        got_pcm, rate = m.wav.read_pcm(wavp, device="cpu")
        got_pcm = got_pcm.numpy()
        assert rate == RATE
        pos = 0
        for i in range(len(audio)):
            ref = m.native.ref_adpcm_decode(bytes(pay_np[i, :alens[i]]),
                                            int(pred_np[i]), int(sidx_np[i]))
            assert np.array_equal(got_pcm[pos:pos + len(ref)], ref), i
            pos += len(ref)
        assert pos == len(got_pcm)
        log(f"decode video: cli.main -> .yuv x3, {N_FRAMES} frames in "
            f"{', '.join(f'{t:.3f}' for t in walls_v)} s, median "
            f"{wall_v:.3f} s = {N_FRAMES / wall_v:.1f} frames/s; every frame "
            f"byte-identical to the C decoder; launches "
            f"{paths['decode video']}")
        log(f"decode audio: cli.main -> .wav x3, {len(got_pcm)} samples in "
            f"{', '.join(f'{t:.3f}' for t in walls_a)} s, median "
            f"{wall_a:.3f} s = {len(got_pcm) / wall_a / 1e6:.2f} Msamples/s; "
            f"identical to the C ADPCM decoder chunk by chunk; launches "
            f"{paths['decode audio']}")
        split = {}
        s = staged(split, "demux", lambda: m.riff.demux(data))
        rows_s, lens_s = staged(split, "unescape", lambda: (
            m.native.unescape_frames(s.video_chunks)))
        order = staged(split, "sort", lambda: np.argsort(
            np.array([len(p) for p in s.video_chunks]), kind="stable"))
        r_t, l_t = staged(split, "to_device", lambda: (
            torch.from_numpy(rows_s[order]).to(dev),
            torch.from_numpy(lens_s[order]).to(dev)))

        def decode_chain():
            lv, _ = m.D.decode_scans(r_t, l_t, nb)
            dc = m.amv_video.resolve_dc(lv.reshape(N_FRAMES, n_mcu, 6, 64))
            return m.U.decode_planes(lv.reshape(-1, 64), dc.reshape(-1), W, H,
                                     dst=torch.from_numpy(order).to(dev))

        planes = staged(split, "device_chain", decode_chain)
        staged(split, "to_host", lambda: [p.cpu().numpy() for p in planes])
        arrs = staged(split, "audio_headers",
                      lambda: m.amv_audio.chunk_arrays(s.audio_chunks))
        ta = staged(split, "audio_to_device", lambda: [
            torch.from_numpy(a).to(dev) for a in arrs[:3]])
        pcm_t = staged(split, "device_A", lambda: m.adpcm.decode_chunks(*ta))
        staged(split, "audio_to_host", lambda: pcm_t.cpu().numpy())
        log_split("decode", split)
        # the transform before this slice (kernel I, the un-sort gather and
        # the assembly copies) against kernel U, alone and in the chain
        lv_c, _ = m.D.decode_scans(r_t, l_t, nb)
        lv_c = lv_c.reshape(-1, 64)
        dc_c = m.amv_video.resolve_dc(
            lv_c.view(N_FRAMES, n_mcu, 6, 64)).reshape(-1)
        inv_t = torch.from_numpy(np.argsort(order)).to(dev)
        ord_t = torch.from_numpy(order).to(dev)

        def transform_i():
            pix = m.idct.idct_blocks(lv_c, dc_c)
            return m.amv_video.assemble_planes(
                pix.reshape(N_FRAMES, n_mcu, 6, 8, 8)[inv_t], mb_w, mb_h, W, H)

        def chain_i():
            lv, _ = m.D.decode_scans(r_t, l_t, nb)
            dc = m.amv_video.resolve_dc(lv.reshape(N_FRAMES, n_mcu, 6, 64))
            pix = m.idct.idct_blocks(lv.reshape(-1, 64), dc.reshape(-1))
            return m.amv_video.assemble_planes(
                pix.reshape(N_FRAMES, n_mcu, 6, 8, 8)[inv_t], mb_w, mb_h, W, H)

        assert all(torch.equal(a, b) for a, b in zip(transform_i(), planes))
        cmp = interleaved({
            "I + assembly": transform_i,
            "U": lambda: m.U.decode_planes(lv_c, dc_c, W, H, dst=ord_t),
            "chain D, I": chain_i, "chain D, U": decode_chain})
        log("decode transform, before (I, un-sort gather, assembly) and "
            "after (U), interleaved, median of 4 (CUDA events, ms): " +
            ", ".join(f"{k} {v:.3f}" for k, v in cmp.items()))
        src_y = raw[:, :W * H].reshape(-1, H, W).copy()
        del planes, pcm_t, r_t, l_t, raw, lv_c, dc_c

        # ---- 7. the encode through the CLI ----------------------------
        yin, win = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "in.wav")
        np.concatenate([p.reshape(N_FRAMES, -1) for p in pics],
                       axis=1).tofile(yin)
        m.wav.write_pcm(win, pcm, RATE)
        m.encode.encode_to_bytes(*(p[:16] for p in pics), pcm[:RATE],
                                 device="cuda")                    # warm-up
        torch.cuda.synchronize()
        reset_launches(m)
        wall_e, walls_e = timed_cli(m, [
            "-i", yin, "-i", win, "-f", "amv", "-s", f"{W}x{H}", "-r",
            str(FPS), "-ar", str(RATE), dst, "--device", "cuda"])
        paths["encode"] = launches(m)
        assert all(paths["encode"][k] > 0 for k in "VEQ") and \
            paths["encode"]["F"] == 0, paths
        with open(dst, "rb") as f:
            out = m.riff.demux(f.read())
        assert out.video_chunks == pays, "video differs from the C encoder"
        t0 = time.perf_counter()
        want_audio = m.ref_adpcm.encode(pcm, frame_size, RATE)
        t_oracle = time.perf_counter() - t0
        assert out.audio_chunks == want_audio, "audio differs from the oracle"
        log(f"encode: cli.main from .yuv + .wav x3, {N_FRAMES} frames + "
            f"{len(pcm)} samples in {', '.join(f'{t:.3f}' for t in walls_e)}"
            f" s, median {wall_e:.3f} s = {N_FRAMES / wall_e:.1f} frames/s; "
            f"video byte-identical to the C encoder, {len(want_audio)} audio "
            f"chunks to the Python ADPCM oracle (which took {t_oracle:.1f} "
            f"s); launches {paths['encode']}")
        split = {}
        planes = staged(split, "to_device", lambda: [
            torch.from_numpy(p).to(dev) for p in pics])

        def encode_chain():
            return m.amv_video.pack_levels(
                m.V.encode_planes(*planes, QSCALE))

        words, bits = staged(split, "device_chain", encode_chain)
        w_np, b_np = staged(split, "to_host", lambda: (
            words.cpu().numpy(), bits.cpu().numpy()))
        vch = staged(split, "escape", lambda: m.native.escape_frames(
            w_np, b_np))
        lay = staged(split, "audio_layout", lambda: (
            m.amv_audio.stream_layout(pcm, frame_size, RATE)))
        tq = staged(split, "audio_to_device", lambda: [
            torch.from_numpy(a[None]).to(dev) for a in lay[2:]])
        bq = staged(split, "device_Q", lambda: m.adpcm.encode_streams(
            *tq, s_q))
        staged(split, "audio_to_host", lambda: [t.cpu().numpy() for t in bq])
        staged(split, "mux", lambda: m.riff.mux(
            vch, want_audio, width=W, height=H, fps=FPS, sample_rate=RATE))
        assert vch == pays
        t_audio = sum(v for k, v in split.items() if "audio" in k or
                      k == "device_Q")
        log_split("encode", split,
                  f"; words copied to the host {tuple(words.shape)}; audio "
                  f"stages {len(pcm) / t_audio / 1e6:.2f} Msamples/s")

        # the transform before this slice (extraction copies and kernel F)
        # against kernel V, alone and in the chain
        def transform_f():
            blk = m.amv_video.extract_blocks(*planes, mb_w, mb_h)
            return m.fdct.fdct_quant_blocks(blk.reshape(-1, 64), qmat)

        def chain_f():
            return m.amv_video.pack_levels(
                transform_f().reshape(N_FRAMES, nb, 64))

        assert torch.equal(transform_f().view(N_FRAMES, nb, 64),
                           m.V.encode_planes(*planes, QSCALE))
        cmp = interleaved({
            "extraction + F": transform_f,
            "V": lambda: m.V.encode_planes(*planes, QSCALE),
            "chain F, E": chain_f, "chain V, E": encode_chain})
        log("encode transform, before (extraction, F) and after (V), "
            "interleaved, median of 4 (CUDA events, ms): " +
            ", ".join(f"{k} {v:.3f}" for k, v in cmp.items()))
        z = [np.zeros((0, H, W), np.uint8)] + 2 * [np.zeros(
            (0, H // 2, W // 2), np.uint8)]
        for quant in m.V.QUANTS:
            got = m.encode.encode_to_bytes(*z, np.zeros(0, np.int16),
                                           quant=quant, device="cuda")
            torch.cuda.synchronize()
            assert got == m.encode.encode_to_bytes(
                *z, np.zeros(0, np.int16), quant=quant, device="cpu")
        log(f"zero-frame encode on the card ({len(got)} bytes, ffmpeg and "
            "q60): equal to the CPU route")
        del planes, words, tq, bq

        # ---- 8. q60 through the CLI -------------------------------------
        q60e = os.path.join(tmp, "q60.amv")
        q60t = os.path.join(tmp, "q60t.amv")
        enc_argv = ["-i", yin, "-i", win, "-f", "amv", "-s", f"{W}x{H}", "-r",
                    str(FPS), "-ar", str(RATE), "-amv_quant", "q60", q60e,
                    "--device", "cuda"]
        tr_argv = ["-i", src, "-f", "amv", "-amv_quant", "q60", q60t,
                   "--device", "cuda"]
        m.cli.main(enc_argv)                                        # warm-up
        m.cli.main(tr_argv)
        torch.cuda.synchronize()
        reset_launches(m)
        wall_qe, walls_qe = timed_cli(m, enc_argv)
        paths["encode q60"] = launches(m)
        reset_launches(m)
        wall_qt, walls_qt = timed_cli(m, tr_argv)
        paths["transcode q60"] = launches(m)
        assert all(paths["encode q60"][k] > 0 for k in "VEQ") and \
            paths["encode q60"]["F"] == 0, paths
        assert all(paths["transcode q60"][k] > 0 for k in "DUVE") and \
            paths["transcode q60"]["T"] == 0, paths
        with open(q60e, "rb") as f:
            qe = m.riff.demux(f.read())
        with open(q60t, "rb") as f:
            qt = m.riff.demux(f.read())
        assert qe.audio_chunks == want_audio and qt.audio_chunks == audio
        db = {}
        for what, got, ref in (("encode", qe, pics[0]),
                               ("transcode", qt, src_y)):
            dec = m.decode.decode_bytes(m.riff.mux(
                got.video_chunks, [], width=W, height=H, fps=FPS),
                device="cuda")
            c_decode_matches(m, got.video_chunks, W, H, dec.y, dec.cb, dec.cr)
            db[what] = psnr(ref, dec.y)
            assert db[what] >= 30.0, (what, db[what])
        assert qe.video_chunks[:N_CPU] == m.amv_video.encode_frames(
            *(p[:N_CPU] for p in pics), quant="q60", device="cpu"), \
            "q60 encode differs from the CPU route"
        cpu_t = m.riff.demux(m.P.transcode_bytes(m.riff.mux(
            pays[:N_CPU], [], width=W, height=H, fps=FPS), quant="q60",
            device="cpu")).video_chunks
        assert qt.video_chunks[:N_CPU] == cpu_t, \
            "q60 transcode differs from the CPU route"
        log(f"q60 encode: cli.main x3, {N_FRAMES} frames + {len(pcm)} samples"
            f" in {', '.join(f'{t:.3f}' for t in walls_qe)} s, median "
            f"{wall_qe:.3f} s = {N_FRAMES / wall_qe:.1f} frames/s; launches "
            f"{paths['encode q60']}")
        log(f"q60 transcode: cli.main x3, {N_FRAMES} frames in "
            f"{', '.join(f'{t:.3f}' for t in walls_qt)} s, median "
            f"{wall_qt:.3f} s = {N_FRAMES / wall_qt:.1f} frames/s; launches "
            f"{paths['transcode q60']}")
        log(f"q60: every payload decodes through the C decoder to the port's "
            f"planes; Y round trip {db['encode']:.2f} dB (encode, against the "
            f"pictures), {db['transcode']:.2f} dB (transcode, against the "
            f"source decode); the first {N_CPU} frames' bytes equal the "
            "port's CPU route; video bytes " + ", ".join(
                f"{k} {sum(map(len, q.video_chunks))} (ffmpeg qscale "
                f"{QSCALE}: {ff_bytes[k]})" for k, q in
                (("encode", qe), ("transcode", qt))))
        del qe, qt, src_y
    log(f"phases 5-8 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 9. width padding and an odd size ---------------------------
    pics_p = pictures(m, N_PAD, H, W_PAD, seed=3)
    pays_p = c_encode(m, pics_p)
    data_p = m.riff.mux(pays_p, [], width=W_PAD, height=H, fps=FPS)
    got = m.riff.demux(m.P.transcode_bytes(data_p, qscale=QSCALE,
                                           device="cuda")).video_chunks
    want_p = c_transcode(m, pays_p, W_PAD, H)
    assert got == want_p, f"{W_PAD}x{H} transcode"
    check_routes(m, pays_p, W_PAD, H, want_p)
    dec = m.decode.decode_bytes(data_p, device="cuda")
    c_decode_matches(m, pays_p, W_PAD, H, dec.y, dec.cb, dec.cr)
    assert m.amv_video.encode_frames(*pics_p, QSCALE, device="cuda") == \
        pays_p, f"{W_PAD}x{H} encode"
    log(f"{W_PAD}x{H}: {N_PAD} frames through the transcode (each entropy "
        "encoder), the decode and the encode, byte-identical to C")
    pics_o = pictures(m, N_PAD, ODD_H, ODD_W, seed=4)
    pays_o = c_encode(m, pics_o)
    data_o = m.riff.mux(pays_o, [], width=ODD_W, height=ODD_H, fps=FPS)
    reset_launches(m)
    got = m.riff.demux(m.P.transcode_bytes(data_o, qscale=QSCALE,
                                           device="cuda")).video_chunks
    odd = launches(m)
    assert all(odd[k] > 0 for k in "DUVE") and odd["T"] == 0, odd
    want_o = c_transcode(m, pays_o, ODD_W, ODD_H)
    assert got == want_o, f"{ODD_W}x{ODD_H} transcode"
    check_routes(m, pays_o, ODD_W, ODD_H, want_o)
    dec = m.decode.decode_bytes(data_o, device="cuda")
    c_decode_matches(m, pays_o, ODD_W, ODD_H, dec.y, dec.cb, dec.cr)
    assert m.amv_video.encode_frames(*pics_o, QSCALE, device="cuda") == \
        pays_o, f"{ODD_W}x{ODD_H} encode"
    assert m.P.transcode_bytes(data_o, quant="q60", device="cuda") == \
        m.P.transcode_bytes(data_o, quant="q60", device="cpu")
    assert m.amv_video.encode_frames(*pics_o, quant="q60", device="cuda") == \
        m.amv_video.encode_frames(*pics_o, quant="q60", device="cpu")
    log(f"{ODD_W}x{ODD_H}: {N_PAD} frames through the two-stage transcode "
        f"(each entropy encoder; launches {odd}), the decode and the "
        "encode, byte-identical to C; the q60 transcode and encode equal "
        "to the port's CPU route")

    # ---- 10. big frames ---------------------------------------------
    big = c_encode(m, pictures(m, 256, 240, 320, seed=2))
    big_data = m.riff.mux(big, [], width=320, height=240, fps=FPS)
    got = m.riff.demux(m.P.transcode_bytes(big_data, qscale=QSCALE,
                                           device="cuda")).video_chunks
    want_big = c_transcode(m, big, 320, 240)
    assert got == want_big, "320x240 differs"
    check_routes(m, big, 320, 240, want_big)
    log(f"320x240: 256 frames (payloads up to {max(len(p) for p in big)} "
        "bytes) byte-identical to the C reference, with each entropy "
        "encoder")
    log(f"phases 9-10 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 11. serving ------------------------------------------------
    t11 = time.perf_counter()
    serving_phase(m, dev, pays, want_c, audio, data, paths)
    log(f"phase 11 took {time.perf_counter() - t11:.1f} s")

    # ---- 19. multi-GPU sharding ---------------------------------------
    sharding_phase(m, dev, paths, smi, pays, want_c)

    # ---- 12. ingest -------------------------------------------------
    ingest_phase(m, dev, paths, smi, check)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 13. trellis --------------------------------------------
        trellis_phase(m, dev, paths, smi, check, kern, pics, pcm, tmp)
        # ---- 14. MJPEG ingest ---------------------------------------
        pics14 = mjpeg_phase(m, dev, paths, smi, check, data, tmp)
        # ---- 18. progressive and lossless MJPEG ingest ----------------
        sof2_sof3_phase(m, dev, paths, smi, check, tmp, pics14)
        del pics14
        # ---- 15. G.729A ---------------------------------------------
        g729_phase(m, dev, paths, smi, kern, extra, tmp, max_mhz, g_sass)
        # ---- 16. G.729A encode --------------------------------------
        g729_encode_phase(m, dev, paths, smi, kern, extra, tmp, k_libs)
    log(f"total {time.perf_counter() - t_start:.1f} s after the imports")

    kernels = []
    for key, name, path, src, replaces, timed in (
            ("D", "entropy_decode", "transcode", "entropy_decode.cu",
             "entropy_async_pallas.py:829", "D"),
            ("T", "transcode", "transcode", "transcode.cu",
             "transcode_layout_pallas.py:207", "T"),
            ("E", "entropy_encode", "transcode", "entropy_encode.cu",
             "entropy_encode_async_pallas.py:940", "E"),
            ("I", "idct_put", "mjpeg ingest", "idct.cu",
             "idct_pallas.py:80", "I mjpeg"),
            ("F", "fdct_quantize", "mjpeg encode", "fdct.cu",
             "fdct_pallas.py:94", "F mjpeg"),
            ("A", "adpcm_decode", "decode audio", "adpcm_decode.cu",
             "adpcm_pallas.py:86", "A"),
            ("Q", "adpcm_encode", "encode", "adpcm_encode.cu",
             "adpcm_encode_pallas.py:89", "Q"),
            ("R", "decode_records", "record decode", "entropy_decode.cu",
             "entropy_async_pallas.py:357", "R"),
            ("X", "expand_records", "record decode", "record_expand.cu",
             "entropy_async_pallas.py:435", "X"),
            ("P", "pack_records", "transcode record", "record_pack.cu",
             "entropy_encode_async_pallas.py:407", "P"),
            ("U", "decode_fused", "decode video", "decode_fused.cu",
             "decode_fused_pallas.py:111", "U"),
            ("V", "encode_fused", "encode", "encode_fused.cu",
             "encode_fused_pallas.py:67", "V"),
            ("L", "adpcm_trellis", "trellis", "adpcm_trellis.cu",
             "amv_tpu/codecs/adpcm_trellis.py:92 (numpy on the host; no TPU "
             "kernel)", "L"),
            ("M", "ms_expand", "wav ms", "adpcm_ms.cu",
             "amv_tpu/kernels/adpcm.py:225 decode_ms_nibbles (lax.scan; no "
             "TPU kernel)", "M"),
            ("G", "g729_decode", "g729 file", "g729_decode.cu",
             "amv_tpu/codecs/g729a.py:596 decode_frame_batch (XLA lax.scan; "
             "no TPU kernel)", "G"),
            ("K", "g729_encode", "g729 encode", "g729_encode.cu",
             "amv_tpu/codecs/g729a_encoder_tpu.py:437 encode_frame_batch (XLA "
             "lax.scan; no TPU kernel)", "K"),
            ("Y", "yuv2rgb_packed", "pixel rgb24", "yuv2rgb_packed.cu",
             "amv_tpu/kernels/yuv2rgb_dither.py:283 yuv420_to_packed (XLA "
             "ops; no TPU kernel)", "Y"),
            ("W", "amvlib_idct", "amvlib api", "amvlib_idct.cu",
             "amv_tpu/codecs/amvlib_video.py:116 decode_transform_amvlib "
             "(XLA ops; no TPU kernel)", "W")):
        err = max(v for k, v in errs.items() if k.split()[0] == key)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"amv_tpu_torch/csrc/{src}",
            "replaces": (replaces if replaces.startswith("amv_tpu/") else
                         f"amv_tpu/kernels/{replaces}"),
            "launches": paths[path][key], "max_abs_err": err,
            "ms": kern[timed]["ms"], "plain_ms": kern[timed]["plain_ms"],
            "bound_ms": kern[timed]["bound_ms"],
            "bound_by": kern[timed]["bound_by"], "library_ms": None,
            **({"passes_ms": kern[key]["passes_ms"],
                "one_chunk_ms": kern[key]["one_chunk_ms"]} if key == "Q"
               else {"q60_ms": kern["V q60"]["ms"]} if key == "V"
               else {"pix_ms": kern["T pixel entry"]["ms"],
                     "deq_ms": kern["T deq entry"]["ms"],
                     "wrap_ms": kern["T wrap"]["ms"],
                     "sass_a_block": sass_t}
               if key == "T"
               else {"wrap_ms": kern["A wrap"]["ms"]} if key == "A"
               else {"layout_ms": kern["I"]["ms"],
                     "progressive_ms": kern["I progressive"]["ms"],
                     "progressive_plain_ms": kern["I progressive"]["plain_ms"],
                     "progressive_bound_ms": kern["I progressive"]["bound_ms"],
                     "progressive_launches": paths["progressive ingest"]["I"]}
               if key == "I"
               else {"layout_ms": kern["F"]["ms"],
                     "raster_corpus_ms": kern["F raster"]["ms"]} if key == "F"
               else {"rounds": kern[key]["rounds"],
                     "chunks_a_round": kern[key]["chunks_a_round"],
                     "chain_ms": kern[key]["chain_ms"]} if key == "L"
               else {"rounds": kern[key]["rounds"]} if key in ("D", "R")
               else {k: v for k, v in kern[key].items() if k not in (
                   "ms", "plain_ms", "bound_ms", "bound_by")}
               if key in ("G", "K")
               else {k: v for k, v in kern[key].items() if k not in (
                   "ms", "plain_ms", "bound_ms", "bound_by")}
               | ({"planes": kern["W planes"]} if key == "W" else
                  {"cli": kern["pixel cli"]})
               if key in ("Y", "W")
               else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
