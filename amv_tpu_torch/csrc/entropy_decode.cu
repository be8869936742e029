// Kernel D: JPEG K.3 Huffman decode of unescaped AMV scans, one thread
// block (CTA) per frame, many threads per scan; and kernel R, a token walk
// emitting the record IR, one thread per frame.
//
// Kernel D replaces the Pallas kernels
//   amv_tpu/kernels/entropy_async_pallas.py:decode_scans_async_dense (the
//     complete chain's decoder), and
//   amv_tpu/kernels/entropy_decode_pallas.py:_decode_layout (its lockstep
//     twin, the ok-gated fallback).
// Semantics are those of the scalar C decoder decode_scan_levels
// (amv_tpu/native/entropy.c:285-332): levels in zigzag order, slot 0 = the
// DC difference, ZRL for run 15 / size 0, no EOB after slot 63.  The scan
// reads MSB-first and zero-fills past lens[f], as br_fill's tail does
// (entropy.c:193-198); the bytes of the aligned words at the ends of row f
// that lie outside it are read but never used.  ok[f] = 0 exactly
// where the C decoder returns an error (an invalid code, size 0 with run !=
// 15, a position past 63) or the token budget budgets[f] runs out; the
// levels decoded before the failing token stay written, none after it.
// Bits after the last block are ignored.
//
// What bounds it on the H100: Huffman decode is bit-serial (a code's
// position depends on every code before it), so latency, not the 0.1 ms
// of bytes, bounds it; one thread per frame ran 4,800 threads on 132
// SMs at ~1,000 cycles a token.  Design: JPEG's codes self-synchronize
// (Weissenberger and Schmidt, ICPP 2018, HiPC 2021), so a CTA splits its
// scan into subsequences of S bits (>= 1,024; at most kMaxSub a row) and
// decodes them in parallel.  The decoder state at a token boundary is (bit
// position, zigzag position, block mod 6: the tables); D writes DC
// differences, so no predictor is part of it.
//  1. Speculate: thread j decodes subsequence j from its first bit with an
//     assumed state (an AC slot of a Y block; subsequence 0 from the exact
//     start) and records the state at the first token boundary past its
//     end, its tokens, the blocks it finishes and its first failing token.
//     A failing token restarts the walk one bit on (only the exact pass
//     decides ok).
//  2. Sync: every entry that differs from its predecessor's exit takes
//     that exit and is decoded again, in parallel, until nothing changes.
//     The prefix whose entries equal their predecessors' exits is exact,
//     and it grows by at least one subsequence a round; a CTA scan of that
//     prefix's tokens and blocks gives each subsequence its first output
//     block and global token index, and stops the sync early once the
//     prefix reaches the frame's last block, a failing token or the
//     budget.  A wrong guess of the block mod 6 does not heal by bits
//     alone (the tables differ), which is what most rounds fix; their
//     count per frame is reported.
//  3. Write: each subsequence up to the stopping one decodes again from its
//     exact entry and writes its levels; the stopping one resolves the end
//     (the last block, or the failing token) in token order.  If the data
//     ends first (a truncated scan), the last subsequence's thread goes on
//     serially into the zero fill until the blocks are done, a code is
//     invalid or the budget runs out.
// The rounds grow with the scan's length, and the frames with the most set
// the kernel's end, so CTA x decodes frame order[x], the longest frames
// first.  Each thread reads the scan through a 64-bit window in registers,
// a word from device memory every ~6 tokens; the token step is selects
// rather than branches, so the lanes of a warp, each at its own token,
// stay together; the tables sit in shared memory in two levels: one
// lookup resolves a code of up to 8 bits, a second the longer ones (whose
// first 8 bits are 0xFA-0xFF in these tables).

// Kernel R replaces amv_tpu/kernels/entropy_async_pallas.py:_decode_records
// (the record-IR decoder): per frame, one 32-bit record per token,
// level << 16 | is_dc << 7 | write << 6 | wpos (entropy_async_pallas.py:
// 308-311), stored record-major [t_rows, F] so that a warp's stores of one
// token row coalesce; rows past a frame's last token stay 0.  Its semantics
// are JAX's, not the C decoder's: a code no table holds reads as length 16
// and the table's last symbol (the threshold decode's clip), size 0 with
// run != 15 writes a 0 level, a position past 63 ends the block, and a
// frame stops only when its blocks are done or t_rows records are spent.
// status[f] = (blocks done, records), and blocks done < n_blocks is JAX's
// not-ok.  Its bit reader is a 64-bit cache over the row, its tables a
// 256-entry first level per Huffman table (entropy.c:144-147) and the
// canonical maxcode/valoff walk for longer codes (JPEG F.16); its token
// loop is flat (one record per iteration), which is also what makes the
// stores of a warp land in one row.  Its walk is serial in a frame, one
// thread per frame.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// per Huffman table (DC-L, DC-C, AC-L, AC-C): e1[256], maxcode[17],
// valoff[17], vals[256] -- amv_tpu_torch/codecs/amv_video.py
constexpr int kTabInts = 256 + 17 + 17 + 256;
constexpr int kAllTabInts = 4 * kTabInts;
constexpr int kVals = 256 + 17 + 17;    // vals[] within a table

struct BitReader {
    const uint8_t *row;
    long long len, pos;
    uint64_t cache;   // top `bits` bits valid, MSB-aligned, zero below
    int bits;

    __device__ __forceinline__ void fill() {
        while (bits <= 56) {
            uint64_t b = pos < len ? row[pos] : 0;
            pos++;
            cache |= b << (56 - bits);
            bits += 8;
        }
    }
    __device__ __forceinline__ void skip(int n) { cache <<= n; bits -= n; }
    // JPEG extend of the next n (1..16) bits; needs n valid bits
    __device__ __forceinline__ int32_t get_extend(int n) {
        uint32_t v = (uint32_t)(cache >> (64 - n));
        skip(n);
        uint32_t neg = ((v >> (n - 1)) & 1u) - 1u;
        return (int32_t)(v - (neg & ((1u << n) - 1u)));
    }
};

// Decode one symbol of table t from a filled reader; returns sym, sets
// *len (0 = invalid code).
__device__ __forceinline__ int decode_sym(const int *tab, uint32_t peek16,
                                          int *len) {
    int ent = tab[peek16 >> 8];
    if (ent) {
        *len = ent & 31;
        return ent >> 5;
    }
    const int *maxcode = tab + 256, *valoff = tab + 273, *vals = tab + 290;
    for (int L = 9; L <= 16; L++) {
        int code = (int)(peek16 >> (16 - L));
        if (code <= maxcode[L]) {
            *len = L;
            return vals[valoff[L] + code];
        }
    }
    *len = 0;
    return 0;
}

// The next symbol of table `tab`: fills the reader, looks the symbol up and
// consumes its code; *len = 0 for an invalid code (nothing consumed).
__device__ __forceinline__ int read_sym(BitReader &br, const int *tab,
                                        int *len) {
    br.fill();
    const int sym = decode_sym(tab, (uint32_t)(br.cache >> 48), len);
    if (*len) br.skip(*len);
    return sym;
}

// the shared-memory copy of the four tables, loaded by every thread block
__device__ __forceinline__ void load_tables(int *tab, const int *tables) {
    for (int i = threadIdx.x; i < kAllTabInts; i += blockDim.x)
        tab[i] = tables[i];
    __syncthreads();
}

// ---- kernel D ------------------------------------------------------------

constexpr int kDThreads = 128;
constexpr int kMaxSub = 128;          // subsequences a frame at most
constexpr int kSMin = 1024;           // subsequence bits at least
constexpr int kGuessPos = 1;          // speculative entry: AC slot 1
// DEC_FAST (codecs/jpeg_tables.py): first levels [4][256], then the
// second levels of the codes longer than 8 bits
constexpr int kFastInts = 4352;

// The frame's scan as big-endian 32-bit words, zero past the data: the
// row's aligned words in device memory, where the scan starts `off` bits
// into the first (a byte swap makes them big-endian).
struct Scan {
    const uint32_t *w;
    int off, nw, end;      // bits before the scan; words holding data; the
                           // byte after the data, counted from w

    __device__ __forceinline__ uint32_t word(int k) const {
        if (k >= nw) return 0;
        const uint32_t v = __byte_perm(__ldg(w + k), 0, 0x0123);
        const int over = 4 * k + 4 - end;            // bytes past the data
        return over > 0 ? v & (0xFFFFFFFFu << (8 * over)) : v;
    }
};

// A reader's 64-bit window on the scan, bits [base, base + 64) of the
// words with base a multiple of 32: a token moves at most 31 bits, so a
// peek slides in at most one word (a load every ~6 tokens).
struct Window {
    Scan sc;
    uint64_t w;
    int base;

    __device__ __forceinline__ Window(const Scan &s, int bp)
        : sc(s), w(0), base((bp + s.off) & ~31) {
        w = ((uint64_t)sc.word(base >> 5) << 32) | sc.word((base >> 5) + 1);
    }
    // the 32 bits from scan bit bp on
    __device__ __forceinline__ uint32_t peek(int bp) {
        bp += sc.off;
        while (bp - base >= 32) {
            base += 32;
            w = (w << 32) | sc.word((base >> 5) + 1);
        }
        return (uint32_t)((w << (bp - base)) >> 32);
    }
};

struct Tok {
    int done, slot;        // the token finished a block; level slot or -1
    int32_t level;
};

// One token of the C decoder from state (bp, pos, c6), pos -1 when the DC
// is next.  false for an invalid token (an invalid code, size 0 with run !=
// 15, a position past 63), the state unchanged.  The outcomes are selects,
// not branches, so that the lanes of a warp, each at its own token, stay
// together; a code longer than 8 bits takes a second table lookup.
__device__ __forceinline__ bool step(Window &win, const uint16_t *fast,
                                     int &bp, int &pos, int &c6, Tok &t) {
    const uint32_t peek = win.peek(bp);
    const bool dc = pos < 0;
    const int tb = (dc ? 0 : 2) + (c6 < 4 ? 0 : 1);
    const int p8 = (int)(peek >> 24);
    int ent = fast[tb * 256 + p8];
    if (!ent) {
        const int lo = tb < 2 ? 0xFF : (tb == 2 ? 0xFB : 0xFA);
        const int base = tb == 0 ? 1024 : (tb == 1 ? 1280 : (tb == 2 ? 1536
                                                                     : 2816));
        ent = p8 >= lo ? fast[base + (p8 - lo) * 256 + ((peek >> 16) & 255)]
                       : 0;
    }
    const int ln = ent & 31, sym = ent >> 5;
    const int nb = dc ? sym : (sym & 15);
    const uint32_t v = nb ? (peek << ln) >> (32 - nb) : 0u;
    const uint32_t neg = nb ? ((v >> (nb - 1)) & 1u) - 1u : 0u;
    const int32_t level = (int32_t)(v - (neg & ((1u << nb) - 1u)));
    const bool eob = !dc && sym == 0, zrl = !dc && sym == 0xF0;
    const int i = pos + (sym >> 4) + 1;
    if (!ln || (!dc && nb == 0 && !eob && !zrl) || (!dc && nb && i > 63))
        return false;
    const bool done = eob || (!dc && nb && i == 63);  // no EOB after 63
    t = {done, dc ? 0 : (nb ? i : -1), level};
    bp += ln + nb;
    pos = dc ? 0 : (zrl ? pos + 16 : (done ? -1 : i));
    c6 = done ? (c6 == 5 ? 0 : c6 + 1) : c6;
    return true;
}

__device__ __forceinline__ int pack_pc(int pos, int c6) {
    return ((pos + 1) << 3) | c6;
}

struct Walk {
    int toks, blks, ftok;  // tokens, blocks finished, first failing token
};

// Decode from (bp, pos, c6) while bp < end: the state moves to the first
// token boundary at or past end; ftok is -1 when no token failed.  A
// failing token restarts the walk one bit on with the speculative guess.
__device__ __forceinline__ Walk walk(const Scan &sc, const uint16_t *fast,
                                     int &bp, int &pos, int &c6, int end) {
    Walk r{0, 0, -1};
    Window win(sc, bp);
    Tok t;
    while (bp < end) {
        r.toks++;
        if (!step(win, fast, bp, pos, c6, t)) {
            if (r.ftok < 0) r.ftok = r.toks - 1;
            bp++;
            pos = kGuessPos;
            continue;
        }
        r.blks += t.done;
    }
    return r;
}

__global__ void __launch_bounds__(kDThreads)
decode_scans_kernel(const uint8_t *__restrict__ rows, long long stride,
                    const long long *__restrict__ lens,
                    const int32_t *__restrict__ order, int n_blocks,
                    const int16_t *__restrict__ tables,
                    const long long *__restrict__ budgets, int S,
                    int16_t *__restrict__ levels, uint8_t *__restrict__ ok,
                    int32_t *__restrict__ rounds) {
    __shared__ uint16_t fast[kFastInts];
    // per subsequence: entry and exit state, and the walk from the entry
    __shared__ int e_bp[kMaxSub], e_pc[kMaxSub], y_bp[kMaxSub], y_pc[kMaxSub];
    __shared__ int n_tok[kMaxSub], n_blk[kMaxSub], f_tok[kMaxSub];
    __shared__ int tok0[kMaxSub], blk0[kMaxSub];   // the scan
    __shared__ int scan_t[2][kMaxSub], scan_b[2][kMaxSub];
    __shared__ uint8_t changed[kMaxSub], todo[kMaxSub];   // a round's re-walks
    __shared__ int s_first, s_stop, s_todo, s_ok;
    const int f = order[blockIdx.x], tid = threadIdx.x;
    for (int i = tid; i < kFastInts; i += kDThreads)
        fast[i] = (uint16_t)tables[i];
    long long len = lens[f];
    len = len < 0 ? 0 : (len > stride ? stride : len);
    const uint8_t *row = rows + (long long)f * stride;
    const int sh = (int)((uintptr_t)row & 3);
    const Scan sc{(const uint32_t *)(row - sh), 8 * sh,
                  (int)((sh + len + 3) >> 2), (int)(sh + len)};
    const long long budget = budgets[f];
    const int n_sub = max(1, (int)((8 * len + S - 1) / S));
    __syncthreads();

    // 1. speculate
    for (int j = tid; j < n_sub; j += kDThreads) {
        int bp = j * S, pos = j ? kGuessPos : -1, c6 = 0;
        e_bp[j] = bp;
        e_pc[j] = pack_pc(pos, c6);
        const Walk r = walk(sc, fast, bp, pos, c6, (j + 1) * S);
        n_tok[j] = r.toks;
        n_blk[j] = r.blks;
        f_tok[j] = r.ftok;
        y_bp[j] = bp;
        y_pc[j] = pack_pc(pos, c6);
    }
    __syncthreads();

    // 2. sync, with the scan of the exact prefix.  A round: entry j
    // changed if it differs from exit j - 1; the subsequences before the
    // first change are exact; their tokens and blocks, scanned, stop the
    // sync at the first one that fails, spends the budget or finishes the
    // frame; otherwise every changed entry takes the exit before it and
    // is walked again, the walks packed into the first threads so that as
    // few warps as can take them run the round.
    int n_rounds = 0;
    for (;;) {
        if (tid == 0) {
            s_first = s_stop = n_sub;
            s_todo = 0;
        }
        for (int j = tid; j < n_sub; j += kDThreads) {
            const bool c = j > 0 && (y_bp[j - 1] != e_bp[j] ||
                                     y_pc[j - 1] != e_pc[j]);
            changed[j] = c;
            scan_t[0][j] = n_tok[j];
            scan_b[0][j] = n_blk[j];
        }
        __syncthreads();
        for (int j = tid; j < n_sub; j += kDThreads)
            if (changed[j]) atomicMin(&s_first, j);
        int src = 0;                         // inclusive scans, Hillis-Steele
        for (int d = 1; d < n_sub; d <<= 1, src ^= 1) {
            for (int j = tid; j < n_sub; j += kDThreads) {
                scan_t[src ^ 1][j] = scan_t[src][j] + (j >= d ? scan_t[src][j - d] : 0);
                scan_b[src ^ 1][j] = scan_b[src][j] + (j >= d ? scan_b[src][j - d] : 0);
            }
            __syncthreads();
        }
        __syncthreads();
        for (int j = tid; j < s_first; j += kDThreads) {
            const int t = scan_t[src][j] - n_tok[j], b = scan_b[src][j] - n_blk[j];
            tok0[j] = t;
            blk0[j] = b;
            if (f_tok[j] >= 0 || b + n_blk[j] >= n_blocks ||
                (long long)t + n_tok[j] > budget)
                atomicMin(&s_stop, j);
        }
        __syncthreads();
        if (s_stop < n_sub) break;
        for (int j = tid; j < n_sub; j += kDThreads)
            if (changed[j]) {
                e_bp[j] = y_bp[j - 1];
                e_pc[j] = y_pc[j - 1];
                todo[atomicAdd(&s_todo, 1)] = (uint8_t)j;
            }
        __syncthreads();
        if (!s_todo) break;
        for (int i = tid; i < s_todo; i += kDThreads) {
            const int j = todo[i];
            int bp = e_bp[j], pos = (e_pc[j] >> 3) - 1, c6 = e_pc[j] & 7;
            const Walk r = walk(sc, fast, bp, pos, c6, (j + 1) * S);
            n_tok[j] = r.toks;
            n_blk[j] = r.blks;
            f_tok[j] = r.ftok;
            y_bp[j] = bp;
            y_pc[j] = pack_pc(pos, c6);
        }
        n_rounds++;
        __syncthreads();
    }

    // 3. write
    const int stop = s_stop < n_sub ? s_stop : -1;
    const int last = stop >= 0 ? stop : n_sub - 1;
    int16_t *out = levels + (long long)f * n_blocks * 64;
    for (int j = tid; j <= last; j += kDThreads) {
        int bp = e_bp[j], pos = (e_pc[j] >> 3) - 1, c6 = e_pc[j] & 7;
        int blk = blk0[j];
        long long tok = tok0[j];
        const bool tail = stop < 0 && j == n_sub - 1;
        const int end = (j + 1) * S;
        int good = -1;
        Window win(sc, bp);
        Tok t;
        while (tail || bp < end) {
            if (blk >= n_blocks) break;
            if (++tok > budget || !step(win, fast, bp, pos, c6, t)) {
                good = 0;
                break;
            }
            if (t.slot >= 0) out[(long long)blk * 64 + t.slot] = (int16_t)t.level;
            blk += t.done;
        }
        if (j == last) s_ok = good != 0 && blk >= n_blocks;
    }
    __syncthreads();
    if (tid == 0) {
        ok[f] = (uint8_t)s_ok;
        rounds[f] = n_rounds;
    }
}

// ---- kernel R ------------------------------------------------------------
__global__ void decode_records_kernel(const uint8_t *__restrict__ rows,
                                      long long stride,
                                      const long long *__restrict__ lens,
                                      int n_frames, int n_blocks,
                                      const int *__restrict__ tables,
                                      long long t_rows,
                                      int32_t *__restrict__ recs,
                                      int32_t *__restrict__ status) {
    __shared__ int tab[kAllTabInts];
    load_tables(tab, tables);
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= n_frames) return;

    long long len = lens[f];
    len = len < 0 ? 0 : (len > stride ? stride : len);
    BitReader br{rows + (long long)f * stride, len, 0, 0, 0};
    int blk = 0, pos = 0, c6 = 0;     // block, next zigzag slot, block % 6
    long long t = 0;
    for (; t < t_rows && blk < n_blocks; t++) {
        const bool is_dc = pos == 0, luma = c6 < 4;
        const int *table = tab + (is_dc ? (luma ? 0 : 1) : (luma ? 2 : 3))
                                 * kTabInts;
        int ln;
        int sym = read_sym(br, table, &ln);
        if (!ln) {                    // JAX: length 16, the last symbol
            br.skip(16);
            sym = table[kVals + (is_dc ? 11 : 161)];
        }
        const int size = is_dc ? sym : (sym & 15);   // DC vals are 0..11
        const int32_t level = size ? br.get_extend(size) : 0;
        int wpos = 0, newpos = 1;
        bool write = true;
        if (!is_dc) {
            const bool eob = sym == 0, zrl = sym == 0xF0;
            wpos = pos + (sym >> 4);
            write = !eob && !zrl && wpos <= 63;
            newpos = eob ? 64 : (zrl ? pos + 16 : wpos + 1);
        }
        recs[t * n_frames + f] = (int32_t)(
            ((uint32_t)level << 16) | ((uint32_t)is_dc << 7) |
            ((uint32_t)write << 6) | (uint32_t)min(wpos, 63));
        if (!is_dc && newpos >= 64) {
            blk++;
            c6 = c6 == 5 ? 0 : c6 + 1;
            pos = 0;
        } else {
            pos = newpos;
        }
    }
    status[2 * f] = blk;
    status[2 * f + 1] = (int32_t)t;
}

}  // namespace

extern "C" int amv_decode_scans(const void *rows, long long stride,
                                const void *lens, const void *order,
                                int n_frames, int n_blocks,
                                const void *tables, const void *budgets,
                                void *levels, void *ok, void *rounds,
                                void *stream) {
    if (n_frames <= 0) return 0;
    // S: at least kSMin bits, and at most kMaxSub subsequences a row
    long long s = (8 * stride + kMaxSub - 1) / kMaxSub;
    s = s < kSMin ? kSMin : (s + 31) / 32 * 32;
    if (s > (1ll << 30)) return (int)cudaErrorInvalidValue;
    decode_scans_kernel<<<n_frames, kDThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)rows, stride, (const long long *)lens,
        (const int32_t *)order, n_blocks,
        (const int16_t *)tables, (const long long *)budgets, (int)s,
        (int16_t *)levels, (uint8_t *)ok, (int32_t *)rounds);
    return (int)cudaGetLastError();
}

extern "C" int amv_decode_records(const void *rows, long long stride,
                                  const void *lens, int n_frames, int n_blocks,
                                  const void *tables, long long t_rows,
                                  void *recs, void *status, void *stream) {
    if (n_frames > 0) {
        const int threads = 64;
        decode_records_kernel<<<(n_frames + threads - 1) / threads, threads,
                                0, (cudaStream_t)stream>>>(
            (const uint8_t *)rows, stride, (const long long *)lens,
            n_frames, n_blocks, (const int *)tables, t_rows,
            (int32_t *)recs, (int32_t *)status);
    }
    return (int)cudaGetLastError();
}

