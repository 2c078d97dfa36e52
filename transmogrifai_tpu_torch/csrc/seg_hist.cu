// seg_hist — one tree level's per-channel histograms, for Hopper.
//
// Replaces the TPU kernel transmogrifai_tpu/models/gbdt_kernels.py
// `_seg_kernel` (launched by `_seg_level_hists`, over the sort-and-pad row
// layout of `_seg_align`).  It computes
//
//     out[c][m][b][j] = sum_i ch[i][c] * [slot_i == m] * [binned[i][j] == b]
//
// for c < C, m < M, b < B, j < d, in float32, with exact zeros for slots
// that hold no rows.  C is the channel count of one launch, a template
// parameter 1..SEG_MAX_CHANNELS: 2 for a boosted level (gradient,
// hessian) and for binary and regression forests, K for a K-class forest
// (K-1 class indicators times the bag weight, and the bag weight).  The
// wrapper runs wider channel sets as several launches, one per group of
// channels, each writing its own channels of `out`.
//
// Layout (built by the wrapper with torch ops, no host synchronisation):
//   perm   (N,)   int64  row ids sorted by slot (stable sort)
//   bounds (M+1,) int32  first sorted position of each slot, then N
// Neither binned nor the channels are gathered into sorted order: the
// kernel reads binned[perm[r]] and ch[perm[r]] through the index.
//
// Row groups.  The sorted positions are cut at every slot bound and at
// every multiple of G = group_rows; each piece is a row group, so a group
// never straddles two slots and holds at most G rows.  Slot s's groups are
// numbered from goff(s) = s + bounds[s] / G (a slot owns one group more
// than it has cuts; that group may be empty), which needs no prefix sum:
// there are M + N / G groups in all.  A block is (row group g, column tile
// t of 128 columns) with `warps` warps, block id g * tiles + t: the tiles
// of a row group run side by side, so a gathered row's segments are read
// close together in time.  Warp w takes the fixed sub-range
// [r0 + w*q, min(r0 + (w+1)*q, r1)) of its group's rows [r0, r1), with
// q = ceil((r1-r0)/warps) <= rows_per_warp (`SEG_ROWS_PER_WARP`, 256),
// so each float32 warp partial sums at most that many rows.  Lane L owns
// the four adjacent columns t*128 + 4L .. +3.
// (`seg_plan` in models/gbdt_kernels.py states the same geometry, and a
// CPU test replays it.)
//
// Per warp, in shared memory:
//   hist [B][4][C][32] float, channels packed in pairs: column 4L+k of the
//                           tile, bin b, holds its C channels in a block of
//                           C x 32 words at (b*4 + k) * C * 32; channel
//                           pair p (channels 2p, 2p+1) is one float2 per
//                           lane at pair row p, an odd last channel one
//                           float per lane after the pairs.  The 32 lanes
//                           touch 32 consecutive words (or 8-byte words)
//                           whatever bins they hold, so there are no bank
//                           conflicts.  A channel pair costs one 64-bit
//                           load, two FADDs and one 64-bit store, half the
//                           shared-memory instructions of one float per
//                           channel; the address takes three integer
//                           instructions a column; a lane's four columns
//                           are four independent chains.  B x 128 x 4C
//                           bytes: at B = 32, 16 KB a channel.
//   ring [4 stages] of 8 rows: the rows' 128-byte tile segments and their
//                           C channels, copied with cp.async (a row's 4C
//                           channel bytes in 16-byte pieces for C % 4 == 0,
//                           8-byte for other even C, else 4-byte).
//                           Three stages are in flight while one is added,
//                           and the copies hold no registers.  Rows whose
//                           stride and base are multiples of 16 bytes (as
//                           `apply_bins` pads them) are copied 16 bytes a
//                           lane, four rows a warp instruction, bypassing
//                           L1; other rows (stride a multiple of 4) 4 bytes
//                           a lane, one row an instruction.
// Row ids are read once per warp, 32 at a time (one per lane, a chunk
// ahead), and passed to the lanes by shuffles.  TMA does not apply: a
// gather through perm is not a tiled box, and TMA's row gather is not on
// sm_90.  After the rows, the block adds its warps' histograms in warp
// order and writes one partial per (group, tile) to scratch
// [group][C][B][tiles*128]; seg_hist_reduce sums each slot's groups in
// group order, in double, into out, writing zeros for empty slots.  No
// float atomics: every sum has a fixed order, so the result is bitwise
// identical from launch to launch and split ties cannot flip between runs;
// integer channels (bag counts times class indicators, sums below 2^24)
// are exact, so they equal any other exact summation bit for bit.
//
// Bound: the function must read binned (N*d bytes), the slots (4 bytes a
// row) and the channels (4C bytes a row) once and write out (M*C*B*d*4
// bytes): at N=1M, d=500, B=32, M=32, C=2 ~0.52 GB, ~0.15 ms at an H100
// SXM's 3.35 TB/s.  The floor of any shared-memory histogram of float32
// channels is higher: each (row, column) reads and writes 8C bytes of
// shared memory, 8 GB a level at 1M x 500 and C = 2, ~0.24 ms at 132 SMs x
// 128 B a clock x 1.98 GHz (the card's top SM clock; ~0.27 ms at 1.75
// GHz).  The bound stays the yardstick; chip_smoke.py prints this floor
// beside it.  Measured on the H100 (PERF.md), the adds, not the gathered
// rows, set the time, and each warp's serial instruction stream sets
// theirs: a 32 KB two-channel histogram per warp leaves room for 6 warps
// an SM, too few to hide one warp's stalls behind another's work, so every
// instruction and latency a row costs shows; hence the short address
// arithmetic below.  More channels leave room for fewer warps (2 an SM at
// C = 5 and B = 32, 1 at C >= 7): less latency hiding, the price of one
// pass over the rows for every channel.  Block shape: at most 2 warps
// (`SEG_WARPS`), chosen by a sweep of 1-6 warps on the H100 at C = 2
// (PERF.md): every shape but 4 warps fits 6 warps an SM (4 fit 4), and 2
// warps halve the partials of 1 at the same groups time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE_COLS = 4;   // columns a lane owns: one 32-bit word
constexpr int TILE = 32 * LANE_COLS;  // columns a warp (and a block) owns
constexpr int ROWS = 8;        // rows a ring stage holds
constexpr int STAGES = 4;      // ring stages per warp
constexpr int CHUNK = 32;      // row ids a warp reads at once
constexpr int MAX_CHANNELS = 13;  // widest launch: 13 x 16 KB fit at B=32
constexpr unsigned FULL = 0xffffffffu;

template <int C>
struct __align__(16) Stage {
    uint32_t word[ROWS][32];   // row v's column word of lane L
    float ch[ROWS * C];        // row v's channels at [v * C, v * C + C)
};

// Bytes of one (bin, column) block of the histogram, and of one bin.
template <int C>
__host__ __device__ constexpr int col_bytes() { return C * 32 * 4; }
template <int C>
__host__ __device__ constexpr int bin_bytes() {
    return LANE_COLS * col_bytes<C>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

template <int W>
__device__ __forceinline__ void cp_async_w(void* dst, const void* src) {
    if constexpr (W == 16) cp_async16(dst, src);
    else if constexpr (W == 8) cp_async8(dst, src);
    else cp_async4(dst, src);
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// First row group of slot s (see the note above).
__device__ __forceinline__ int goff(const int32_t* bounds, int s, int G) {
    return s + bounds[s] / G;
}

// Bytes a channel copy moves: the widest of 16, 8 and 4 that divides a
// row's 4C bytes (the wrapper checks that the channels' base is aligned
// to it; contiguous rows keep every row aligned).
template <int C>
__host__ __device__ constexpr int ch_copy_bytes() {
    return C % 4 == 0 ? 16 : C % 2 == 0 ? 8 : 4;
}

// The rows one warp adds: sorted positions [a, e) of its sub-range.
template <bool WIDE, int C>
struct WarpRows {
    const uint8_t* __restrict__ binned;
    const int64_t* __restrict__ perm;
    const float* __restrict__ ch;
    long long stride;   // bytes between rows of binned
    int a, e, d, col0, lane;
    bool active;        // the lane's column word lies inside d
    int64_t rid_cur, rid_next;  // row ids of the issuing chunk and the next

    // Stage the rows of batch i (sorted positions a + 8i ..) into `st`.
    // Batches are issued in order; batch i's row ids come from the chunk
    // of 32 that holds it, and the chunk after it is loaded one chunk
    // ahead of use.  Commits one cp.async group, empty past the range.
    __device__ __forceinline__ void issue(int i, Stage<C>& st) {
        constexpr int BPC = CHUNK / ROWS;  // batches per chunk
        if (i > 0 && i % BPC == 0) {
            rid_cur = rid_next;
            const int r = a + CHUNK * (i / BPC + 1) + lane;
            rid_next = r < e ? __ldg(perm + r) : 0;
        }
        const int base = a + ROWS * i;
        const int first = ROWS * (i % BPC);  // batch's first id in the chunk
        if (WIDE) {
            // lane L copies 16 bytes (chunk L % 8) of row L / 8 + 4h
            const int c16 = col0 + 16 * (lane & 7);
#pragma unroll
            for (int h = 0; h < ROWS / 4; ++h) {
                const int v = 4 * h + (lane >> 3);
                const int64_t rid = __shfl_sync(FULL, rid_cur, first + v);
                if (base + v < e && c16 < d)
                    cp_async16(&st.word[v][4 * (lane & 7)],
                               binned + rid * stride + c16);
            }
        } else {
#pragma unroll
            for (int v = 0; v < ROWS; ++v) {
                const int64_t rid = __shfl_sync(FULL, rid_cur, first + v);
                if (base + v < e && active)
                    cp_async4(&st.word[v][lane],
                              binned + rid * stride + col0 + 4 * lane);
            }
        }
        // the channels: copy j is piece j % PER_ROW of row j / PER_ROW
        constexpr int W = ch_copy_bytes<C>();
        constexpr int PER_ROW = C * 4 / W;
        constexpr int N = ROWS * PER_ROW;
#pragma unroll
        for (int j0 = 0; j0 < N; j0 += 32) {
            const int j = j0 + lane;
            const int v = (j / PER_ROW) % ROWS;
            const int piece = j - (j / PER_ROW) * PER_ROW;
            const int64_t rid = __shfl_sync(FULL, rid_cur, first + v);
            if (j < N && base + v < e)
                cp_async_w<W>(&st.ch[v * C + piece * (W / 4)],
                              ch + rid * C + piece * (W / 4));
        }
        cp_async_commit();
    }
};

__device__ __forceinline__ float2 lds64(unsigned a) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
    return v;
}

__device__ __forceinline__ void sts64(unsigned a, float2 v) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                 ::"r"(a), "f"(v.x), "f"(v.y) : "memory");
}

__device__ __forceinline__ float lds32(unsigned a) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
    return v;
}

__device__ __forceinline__ void sts32(unsigned a, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// Shared-memory address of the first channel pair's word that byte k of
// a lane's staged word adds to: column k of bin b lies at base + b *
// bin_bytes + k * col_bytes, `base` being the lane's pair word of bin 0,
// column 0 (one byte permute, one min and one multiply-add a column).  A
// bin is clamped to bmax = B-1, so a value >= B (outside the contract) can
// never leave the histogram; a padding byte past column d lands in a
// padding column, never read.
template <int C>
__device__ __forceinline__ unsigned hist_addr(unsigned base, uint32_t word,
                                              int k, int bmax) {
    const int b = min((int)__byte_perm(word, 0, 0x4440 + k), bmax);
    return base + b * bin_bytes<C>() + k * col_bytes<C>();
}

// Adds one row's channels `c` at the lane's four column addresses `a`:
// every pair word and odd word is loaded first, then added and stored
// (distinct addresses whatever the bins; only the next row's loads, which
// may hit the same bins, follow the stores).  `tail` is the odd channel's
// offset from a pair address: after the C/2 pair rows of 256 bytes, a row
// of 4-byte lane words.
template <int C>
__device__ __forceinline__ void add_row(const unsigned (&a)[LANE_COLS],
                                        const float (&c)[C], int tail) {
    constexpr int NP = C / 2;
    float2 x[LANE_COLS][NP > 0 ? NP : 1];
    float t[LANE_COLS];
#pragma unroll
    for (int k = 0; k < LANE_COLS; ++k) {
#pragma unroll
        for (int p = 0; p < NP; ++p) x[k][p] = lds64(a[k] + p * 256);
        if constexpr (C & 1) t[k] = lds32(a[k] + tail);
    }
#pragma unroll
    for (int k = 0; k < LANE_COLS; ++k) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            x[k][p].x += c[2 * p];
            x[k][p].y += c[2 * p + 1];
            sts64(a[k] + p * 256, x[k][p]);
        }
        if constexpr (C & 1) {
            t[k] += c[C - 1];
            sts32(a[k] + tail, t[k]);
        }
    }
}

// Adds staged rows [0, rows) of a stage (rows <= ROWS; FULL: rows ==
// ROWS, known at compile time) into the lane's four columns of the warp
// histogram.  All the stage's addresses are computed first; two channels
// are read for all rows at once (two rows a load), more a row at a time
// (shared-memory broadcasts).
template <int C, bool FULL>
__device__ __forceinline__ void add_rows(unsigned base, const Stage<C>& st,
                                         int rows, int lane, int bmax,
                                         int tail) {
    unsigned a[ROWS][LANE_COLS];
    float2 c2[ROWS];
    if constexpr (C == 2) {
#pragma unroll
        for (int v = 0; v < ROWS; v += 2) {
            const float4 p = *reinterpret_cast<const float4*>(&st.ch[2 * v]);
            c2[v] = make_float2(p.x, p.y);
            c2[v + 1] = make_float2(p.z, p.w);
        }
    }
#pragma unroll
    for (int v = 0; v < ROWS; ++v) {
        const uint32_t word = st.word[v][lane];
#pragma unroll
        for (int k = 0; k < LANE_COLS; ++k)
            a[v][k] = hist_addr<C>(base, word, k, bmax);
    }
#pragma unroll
    for (int v = 0; v < ROWS; ++v) {
        if (FULL || v < rows) {
            float c[C];
            if constexpr (C == 2) {
                c[0] = c2[v].x;
                c[1] = c2[v].y;
            } else {
#pragma unroll
                for (int q = 0; q < C; ++q) c[q] = st.ch[v * C + q];
            }
            add_row<C>(a[v], c, tail);
        }
    }
}

// Float offset, within a (bin, column) block, of lane l's word of
// channel c (see the layout above).
template <int C>
__device__ __forceinline__ int chan_word(int c, int l) {
    return c < (C & ~1) ? 64 * (c >> 1) + 2 * l + (c & 1)
                        : 64 * (C / 2) + l;
}

template <bool WIDE, int C>
__global__ void seg_hist_groups(const uint8_t* __restrict__ binned,
                                const int64_t* __restrict__ perm,
                                const float* __restrict__ ch,
                                const int32_t* __restrict__ bounds,
                                float* __restrict__ scratch,
                                long long stride, int d, int M, int B,
                                int G) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warps = blockDim.x >> 5;
    const int n_tiles = (d + TILE - 1) / TILE;
    const int g = blockIdx.x / n_tiles;
    const int t = blockIdx.x % n_tiles;
    // slot s owning group g: last s with goff(s) <= g (goff(0) = 0 and
    // goff(M) = n_groups > g)
    int lo = 0, hi = M;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (goff(bounds, mid, G) <= g) lo = mid; else hi = mid;
    }
    const int s = lo;
    const int j = g - goff(bounds, s, G);
    const int cut = bounds[s] / G + j;  // chunk of G positions holding g
    const int r0 = j == 0 ? bounds[s] : cut * G;
    const int r1 = max(r0, min(bounds[s + 1], (cut + 1) * G));
    const int q = (r1 - r0 + warps - 1) / warps;

    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    constexpr int HWORDS = TILE * C;  // floats of one bin of a warp's hist
    float* hist = reinterpret_cast<float*>(smem) + (size_t)w * B * HWORDS;
    Stage<C>* ring = reinterpret_cast<Stage<C>*>(
                         smem + (size_t)warps * B * HWORDS * sizeof(float))
                     + w * STAGES;

    // 8-byte stores: the 16-byte form measured slower on the H100
    const float2 zero = make_float2(0.0f, 0.0f);
    for (int k = lane; k < B * HWORDS / 2; k += 32)
        reinterpret_cast<float2*>(hist)[k] = zero;
    const unsigned hist_base = smem_addr(hist) + 8 * lane;
    const int tail = (C / 2) * 256 - 4 * lane;

    WarpRows<WIDE, C> wr;
    wr.binned = binned;
    wr.perm = perm;
    wr.ch = ch;
    wr.stride = stride;
    wr.a = min(r0 + w * q, r1);
    wr.e = min(wr.a + q, r1);
    wr.d = d;
    wr.col0 = t * TILE;
    wr.lane = lane;
    wr.active = wr.col0 + LANE_COLS * lane < d;
    wr.rid_cur = wr.a + lane < wr.e ? __ldg(perm + wr.a + lane) : 0;
    wr.rid_next = wr.a + CHUNK + lane < wr.e
                      ? __ldg(perm + wr.a + CHUNK + lane) : 0;
    const int nb = (wr.e - wr.a + ROWS - 1) / ROWS;
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) wr.issue(i, ring[i]);
    __syncwarp();
    for (int i = 0; i < nb; ++i) {
        // stage (i-1) % STAGES was added in the last pass and is free
        wr.issue(i + STAGES - 1, ring[(i + STAGES - 1) % STAGES]);
        cp_async_wait_all_but_newest();  // this lane's batch i landed
        __syncwarp();                    // ... and every lane's
        const Stage<C>& st = ring[i % STAGES];
        if (wr.active) {
            const int rows = wr.e - wr.a - ROWS * i;
            if (rows >= ROWS)
                add_rows<C, true>(hist_base, st, ROWS, lane, B - 1, tail);
            else
                add_rows<C, false>(hist_base, st, rows, lane, B - 1, tail);
        }
        __syncwarp();  // every lane is done with stage i before its reuse
    }
    __syncthreads();

    // The block's partial: its warps' histograms added in warp order.
    // Thread e takes bin e / 32 and the four columns of lane e % 32, and
    // writes them as one float4 per channel (tile-padded rows: aligned and
    // unmasked; the padding columns hold what padding bytes added), a
    // channel pair at a time.
    const int width = n_tiles * TILE;
    const float* hsm = reinterpret_cast<const float*>(smem);
    float* dst = scratch + (size_t)g * C * B * width + t * TILE;
    for (int e = threadIdx.x; e < B * 32; e += blockDim.x) {
        const int b = e >> 5, l = e & 31;
        float* row = dst + (size_t)b * width + LANE_COLS * l;
#pragma unroll
        for (int p = 0; p < (C + 1) / 2; ++p) {
            const bool pair = 2 * p + 1 < C;
            float s0[LANE_COLS], s1[LANE_COLS];
#pragma unroll
            for (int k = 0; k < LANE_COLS; ++k) {
                const float* src = hsm + (b * LANE_COLS + k) * (C * 32);
                if (pair) {
                    const float2* s2 = reinterpret_cast<const float2*>(
                        src + chan_word<C>(2 * p, l));
                    float2 acc = s2[0];
                    for (int v = 1; v < warps; ++v) {
                        const float2 x = s2[(size_t)v * B * HWORDS / 2];
                        acc.x += x.x;
                        acc.y += x.y;
                    }
                    s0[k] = acc.x;
                    s1[k] = acc.y;
                } else {
                    const float* s1p = src + chan_word<C>(2 * p, l);
                    float acc = s1p[0];
                    for (int v = 1; v < warps; ++v)
                        acc += s1p[(size_t)v * B * HWORDS];
                    s0[k] = acc;
                }
            }
            *reinterpret_cast<float4*>(row + (size_t)(2 * p) * B * width) =
                make_float4(s0[0], s0[1], s0[2], s0[3]);
            if (pair)
                *reinterpret_cast<float4*>(
                    row + (size_t)(2 * p + 1) * B * width) =
                    make_float4(s1[0], s1[1], s1[2], s1[3]);
        }
    }
}

constexpr int REDUCE_BATCH = 8;  // group partials a thread loads at once

// Thread e of grid row m adds columns 4*j4 .. +3 of scratch row cb
// (= c * B + b) over slot m's groups: e = cb * ceil(d/4) + j4.
__global__ void seg_hist_reduce(const float* __restrict__ scratch,
                                const int32_t* __restrict__ bounds,
                                float* __restrict__ out, int nchan,
                                int d, int width, int M, int B, int G) {
    const int m = blockIdx.y;
    const int d4 = (d + 3) / 4;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= nchan * B * d4) return;
    const int cb = e / d4;
    const int j = 4 * (e - cb * d4);
    const size_t per_group = (size_t)nchan * B * width / 4;  // in float4
    const float4* src =
        reinterpret_cast<const float4*>(scratch + (size_t)cb * width + j);
    const int g0 = goff(bounds, m, G), g1 = goff(bounds, m + 1, G);
    // double across groups: a slot's group partials can be large while
    // their sum is near 0; one rounding at the end keeps the result within
    // the float32 tolerance of the exact sum at a million rows.  Loads go
    // out REDUCE_BATCH at a time (16 bytes each: scratch rows are padded
    // to whole tiles); the adds stay in group order.
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    for (int g = g0; g < g1; g += REDUCE_BATCH) {
        float4 x[REDUCE_BATCH];
#pragma unroll
        for (int u = 0; u < REDUCE_BATCH; ++u)
            if (g + u < g1) x[u] = src[(size_t)(g + u) * per_group];
#pragma unroll
        for (int u = 0; u < REDUCE_BATCH; ++u) {
            if (g + u < g1) {
                acc[0] += (double)x[u].x;
                acc[1] += (double)x[u].y;
                acc[2] += (double)x[u].z;
                acc[3] += (double)x[u].w;
            }
        }
    }
    const int c = cb / B;
    float* dst = out + ((size_t)c * M + m) * B * d + (size_t)(cb - c * B) * d;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (j + k < d) dst[j + k] = (float)acc[k];
}

template <bool WIDE, int C>
int launch_groups(const void* binned, const void* perm, const void* ch,
                  const void* bounds, void* scratch, long long stride, int d,
                  int M, int B, int warps, int G, int n_groups,
                  cudaStream_t st) {
    const int smem = warps * (B * TILE * C * (int)sizeof(float)
                              + STAGES * (int)sizeof(Stage<C>));
    cudaError_t err = cudaFuncSetAttribute(
        seg_hist_groups<WIDE, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = (d + TILE - 1) / TILE;
    seg_hist_groups<WIDE, C><<<n_groups * n_tiles, 32 * warps, smem, st>>>(
        (const uint8_t*)binned, (const int64_t*)perm, (const float*)ch,
        (const int32_t*)bounds, (float*)scratch, stride, d, M, B, G);
    return (int)cudaGetLastError();
}

template <int C>
int launch_groups_c(int wide, const void* binned, const void* perm,
                    const void* ch, const void* bounds, void* scratch,
                    long long stride, int d, int M, int B, int warps, int G,
                    int n_groups, cudaStream_t st) {
    return wide ? launch_groups<true, C>(binned, perm, ch, bounds, scratch,
                                         stride, d, M, B, warps, G,
                                         n_groups, st)
                : launch_groups<false, C>(binned, perm, ch, bounds, scratch,
                                          stride, d, M, B, warps, G,
                                          n_groups, st);
}

}  // namespace

// Launches both passes for the (N, nchan) row-major float32 channels `ch`
// (1 <= nchan <= MAX_CHANNELS; base aligned to the copy width: 16 bytes
// for nchan % 4 == 0, 8 for other even nchan, else 4) on `stream`.  `out`
// points at the first of this launch's channels in a (channels, M, B, d)
// output.
// `warps`, `group_rows` (G) and `n_groups` (M + N / G) come from
// `seg_plan`; the grid holds n_groups x ceil(d / 128) blocks.  `wide`
// selects the 16-byte row copies and needs binned's base and row stride to
// be multiples of 16 bytes and its storage to hold the last row's 16-byte
// chunk; otherwise both must be multiples of 4.  The caller keeps the
// shared memory, warps x (B x 128 x 4 nchan + 4 x (1024 + 32 nchan))
// bytes, within a block's 227 KiB, M within gridDim.y (M <= 65535) and
// nchan x B x d below 2^31, and sizes scratch (n_groups, nchan, B,
// ceil(d/128)*128) float32.  Returns the cudaError_t of the launches (0 on
// success; cudaErrorInvalidValue for a channel count outside the build).
extern "C" int seg_hist_launch(const void* binned, const void* perm,
                               const void* ch, const void* bounds,
                               void* scratch, void* out, long long stride,
                               int nchan, int d, int M, int B, int warps,
                               int group_rows, int n_groups, int wide,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int err;
#define SEG_CASE(CC)                                                        \
    case CC:                                                                \
        err = launch_groups_c<CC>(wide, binned, perm, ch, bounds, scratch,  \
                                  stride, d, M, B, warps, group_rows,       \
                                  n_groups, st);                            \
        break;
    switch (nchan) {
        SEG_CASE(1) SEG_CASE(2) SEG_CASE(3) SEG_CASE(4) SEG_CASE(5)
        SEG_CASE(6) SEG_CASE(7) SEG_CASE(8) SEG_CASE(9) SEG_CASE(10)
        SEG_CASE(11) SEG_CASE(12) SEG_CASE(13)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef SEG_CASE
    static_assert(MAX_CHANNELS == 13, "one SEG_CASE per channel count");
    if (err != 0) return err;
    dim3 grid2((unsigned)((nchan * B * ((d + 3) / 4) + 255) / 256), M);
    const int width = (d + TILE - 1) / TILE * TILE;
    seg_hist_reduce<<<grid2, 256, 0, st>>>(
        (const float*)scratch, (const int32_t*)bounds, (float*)out, nchan, d,
        width, M, B, group_rows);
    return (int)cudaGetLastError();
}
