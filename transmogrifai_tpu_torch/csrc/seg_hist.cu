// seg_hist — one tree level's per-channel gradient histograms, for Hopper.
//
// Replaces the TPU kernel transmogrifai_tpu/models/gbdt_kernels.py
// `_seg_kernel` (launched by `_seg_level_hists`, over the sort-and-pad row
// layout of `_seg_align`).  It computes
//
//     out[c][m][b][j] = sum_i ch[i][c] * [slot_i == m] * [binned[i][j] == b]
//
// for c < 2 (gradient, hessian of the binary objective), m < M, b < B,
// j < d, in float32, with exact zeros for slots that hold no rows.
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
// q = ceil((r1-r0)/warps) <= 1024, so each float32 warp partial sums at
// most 1024 rows.  Lane L owns the four adjacent columns t*128 + 4L .. +3.
// (`seg_plan` in models/gbdt_kernels.py states the same geometry, and a
// CPU test replays it.)
//
// Per warp, in shared memory:
//   hist [B][4][32] float2  (gradient, hessian) packed, column 4L+k of the
//                           tile at [b][k][L]: the 32 lanes touch 32
//                           consecutive 8-byte words whatever bins they
//                           hold (the bin stride is 1024 B, a multiple of
//                           the 32 banks), so there are no bank conflicts.
//                           An element costs one 64-bit load, two FADDs and
//                           one 64-bit store, half the shared-memory
//                           instructions of one float per channel, and
//                           three integer instructions for its address;
//                           the four columns of a lane are four
//                           independent chains.
//   ring [4 stages] of 8 rows: the rows' 128-byte tile segments and their
//                           channel pairs, copied with cp.async (lane v
//                           copies row v's channel pair).  Three stages are
//                           in flight while one is added, and the copies
//                           hold no registers.  Rows whose stride and base
//                           are multiples of 16 bytes (as `apply_bins` pads
//                           them) are copied 16 bytes a lane, four rows a
//                           warp instruction, bypassing L1; other rows
//                           (stride a multiple of 4) 4 bytes a lane, one
//                           row an instruction.
// Row ids are read once per warp, 32 at a time (one per lane, a chunk
// ahead), and passed to the lanes by shuffles.  TMA does not apply: a
// gather through perm is not a tiled box, and TMA's row gather is not on
// sm_90.  After the rows, the block adds its warps' histograms in warp
// order and writes one partial per (group, tile) to scratch
// [group][2][B][tiles*128]; seg_hist_reduce sums each slot's groups in
// group order, in double, into out, writing zeros for empty slots.  No
// float atomics: every sum has a fixed order, so the result is bitwise
// identical from launch to launch and split ties cannot flip between runs.
//
// Bound: the function must read binned (N*d bytes), the slots (4 bytes a
// row) and the channels (8 bytes a row) once and write out (M*2*B*d*4
// bytes): at N=1M, d=500, B=32, M=32 ~0.52 GB, ~0.15 ms at an H100 SXM's
// 3.35 TB/s.  The floor of any shared-memory histogram with two float32
// channels is higher: each (row, column) reads and writes 16 bytes of
// shared memory, 8 GB a level at 1M x 500, ~0.24 ms at 132 SMs x 128 B a
// clock x 1.98 GHz (the card's top SM clock; ~0.27 ms at 1.75 GHz).  The
// bound stays the yardstick; chip_smoke.py prints this floor beside it.
// Measured on the H100 (PERF.md), the adds, not the gathered rows, set the
// time, and each warp's serial instruction stream sets theirs: a 32 KB
// float2 histogram per warp leaves room for 6 warps an SM, too few to hide
// one warp's stalls behind another's work, so every instruction and
// latency a row costs shows; hence the short address arithmetic below.
// Block shape: 2 warps (`SEG_WARPS`), chosen by a sweep of 1-6 warps on
// the H100 (PERF.md): every shape but 4 warps fits 6 warps an SM (4 fit
// 4), and 2 warps halve the partials of 1 at the same groups time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCHAN = 2;       // channels: gradient, hessian
constexpr int LANE_COLS = 4;   // columns a lane owns: one 32-bit word
constexpr int TILE = 32 * LANE_COLS;  // columns a warp (and a block) owns
constexpr int ROWS = 8;        // rows a ring stage holds
constexpr int STAGES = 4;      // ring stages per warp
constexpr int CHUNK = 32;      // row ids a warp reads at once
constexpr unsigned FULL = 0xffffffffu;

struct Stage {
    uint32_t word[ROWS][32];   // row v's column word of lane L
    float2 ch[ROWS];           // row v's (gradient, hessian)
};

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

// The rows one warp adds: sorted positions [a, e) of its sub-range.
template <bool WIDE>
struct WarpRows {
    const uint8_t* __restrict__ binned;
    const int64_t* __restrict__ perm;
    const float2* __restrict__ ch;
    long long stride;   // bytes between rows of binned
    int a, e, d, col0, lane;
    bool active;        // the lane's column word lies inside d
    int64_t rid_cur, rid_next;  // row ids of the issuing chunk and the next

    // Stage the rows of batch i (sorted positions a + 8i ..) into `st`.
    // Batches are issued in order; batch i's row ids come from the chunk
    // of 32 that holds it, and the chunk after it is loaded one chunk
    // ahead of use.  Commits one cp.async group, empty past the range.
    __device__ __forceinline__ void issue(int i, Stage& st) {
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
        const int64_t rid = __shfl_sync(FULL, rid_cur, first + lane % ROWS);
        if (lane < ROWS && base + lane < e) cp_async8(&st.ch[lane], ch + rid);
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

// Shared-memory address of the histogram word that byte k of a lane's
// staged word adds to: column k of bin b lies at base + b * 1024 + k * 256,
// `base` being the lane's word of bin 0, column 0 (one byte permute, one
// min and one multiply-add a column).  A bin is clamped to bmax = B-1, so a
// value >= B (outside the contract) can never leave the histogram; a
// padding byte past column d lands in a padding column, never read.
__device__ __forceinline__ unsigned hist_addr(unsigned base, uint32_t word,
                                              int k, int bmax) {
    const int b = min((int)__byte_perm(word, 0, 0x4440 + k), bmax);
    return base + b * (LANE_COLS * 32 * (int)sizeof(float2))
           + k * 32 * (int)sizeof(float2);
}

// Adds staged rows [0, rows) of a stage (rows <= ROWS; FULL: rows ==
// ROWS, known at compile time) into the lane's four columns of the warp
// histogram.  All the stage's addresses and channel pairs (two rows a
// load) are read first; then, a row at a time, the four columns' words are
// loaded, added and stored as four independent chains (distinct addresses
// whatever the bins; only the next row's loads, which may hit the same
// bins, follow the stores).
template <bool FULL>
__device__ __forceinline__ void add_rows(unsigned base, const Stage& st,
                                         int rows, int lane, int bmax) {
    unsigned a[ROWS][LANE_COLS];
    float2 c[ROWS];
#pragma unroll
    for (int v = 0; v < ROWS; v += 2) {
        const float4 p = *reinterpret_cast<const float4*>(&st.ch[v]);
        c[v] = make_float2(p.x, p.y);
        c[v + 1] = make_float2(p.z, p.w);
    }
#pragma unroll
    for (int v = 0; v < ROWS; ++v) {
        const uint32_t word = st.word[v][lane];
#pragma unroll
        for (int k = 0; k < LANE_COLS; ++k)
            a[v][k] = hist_addr(base, word, k, bmax);
    }
#pragma unroll
    for (int v = 0; v < ROWS; ++v) {
        if (FULL || v < rows) {
            float2 x[LANE_COLS];
#pragma unroll
            for (int k = 0; k < LANE_COLS; ++k) x[k] = lds64(a[v][k]);
#pragma unroll
            for (int k = 0; k < LANE_COLS; ++k) {
                x[k].x += c[v].x;
                x[k].y += c[v].y;
                sts64(a[v][k], x[k]);
            }
        }
    }
}

template <bool WIDE>
__global__ void seg_hist_groups(const uint8_t* __restrict__ binned,
                                const int64_t* __restrict__ perm,
                                const float2* __restrict__ ch,
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
    float2* hist = reinterpret_cast<float2*>(smem) + (size_t)w * B * TILE;
    Stage* ring = reinterpret_cast<Stage*>(
                      smem + (size_t)warps * B * TILE * sizeof(float2))
                  + w * STAGES;

    const float2 zero = make_float2(0.0f, 0.0f);
    for (int k = lane; k < B * TILE; k += 32) hist[k] = zero;
    const unsigned hist_base = smem_addr(hist + lane);

    WarpRows<WIDE> wr;
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
        const Stage& st = ring[i % STAGES];
        if (wr.active) {
            const int rows = wr.e - wr.a - ROWS * i;
            if (rows >= ROWS)
                add_rows<true>(hist_base, st, ROWS, lane, B - 1);
            else
                add_rows<false>(hist_base, st, rows, lane, B - 1);
        }
        __syncwarp();  // every lane is done with stage i before its reuse
    }
    __syncthreads();

    // The block's partial: its warps' histograms added in warp order.
    // Thread e takes bin e / 32 and the four columns of lane e % 32, and
    // writes them as one float4 per channel (tile-padded rows: aligned and
    // unmasked; the padding columns hold what padding bytes added).
    const int width = n_tiles * TILE;
    float* dst = scratch + (size_t)g * NCHAN * B * width + t * TILE;
    for (int e = threadIdx.x; e < B * 32; e += blockDim.x) {
        const int b = e >> 5, l = e & 31;
        float gsum[LANE_COLS], hsum[LANE_COLS];
#pragma unroll
        for (int k = 0; k < LANE_COLS; ++k) {
            const float2* src = reinterpret_cast<const float2*>(smem)
                                + (b * LANE_COLS + k) * 32 + l;
            float2 acc = src[0];
            for (int v = 1; v < warps; ++v) {
                const float2 x = src[(size_t)v * B * TILE];
                acc.x += x.x;
                acc.y += x.y;
            }
            gsum[k] = acc.x;
            hsum[k] = acc.y;
        }
        float* row = dst + (size_t)b * width + LANE_COLS * l;
        *reinterpret_cast<float4*>(row) =
            make_float4(gsum[0], gsum[1], gsum[2], gsum[3]);
        *reinterpret_cast<float4*>(row + (size_t)B * width) =
            make_float4(hsum[0], hsum[1], hsum[2], hsum[3]);
    }
}

constexpr int REDUCE_BATCH = 8;  // group partials a thread loads at once

// Thread e of grid row m adds columns 4*j4 .. +3 of scratch row cb
// (= c * B + b) over slot m's groups: e = cb * ceil(d/4) + j4.
__global__ void seg_hist_reduce(const float* __restrict__ scratch,
                                const int32_t* __restrict__ bounds,
                                float* __restrict__ out,
                                int d, int width, int M, int B, int G) {
    const int m = blockIdx.y;
    const int d4 = (d + 3) / 4;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= NCHAN * B * d4) return;
    const int cb = e / d4;
    const int j = 4 * (e - cb * d4);
    const size_t per_group = (size_t)NCHAN * B * width / 4;  // in float4
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

template <bool WIDE>
int launch_groups(const void* binned, const void* perm, const void* ch,
                  const void* bounds, void* scratch, long long stride, int d,
                  int M, int B, int warps, int G, int n_groups,
                  cudaStream_t st) {
    const int smem = warps * (B * TILE * (int)sizeof(float2)
                              + STAGES * (int)sizeof(Stage));
    cudaError_t err = cudaFuncSetAttribute(
        seg_hist_groups<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = (d + TILE - 1) / TILE;
    seg_hist_groups<WIDE><<<n_groups * n_tiles, 32 * warps, smem, st>>>(
        (const uint8_t*)binned, (const int64_t*)perm, (const float2*)ch,
        (const int32_t*)bounds, (float*)scratch, stride, d, M, B, G);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches both passes on `stream`.  `warps`, `group_rows` (G) and
// `n_groups` (M + N / G) come from `seg_plan`; the grid holds n_groups x
// ceil(d / 128) blocks.  `wide` selects the 16-byte row copies and needs
// binned's base and row stride to be multiples of 16 bytes and its
// storage to hold the last row's 16-byte chunk; otherwise both must be
// multiples of 4.  The caller keeps the shared memory, warps x (B x 128 x
// 8 + 4 x 1088) bytes, within a block's 227 KiB, M within gridDim.y
// (M <= 65535) and 2 x B x d below 2^31, and sizes scratch (n_groups, 2,
// B, ceil(d/128)*128) float32.  Returns the cudaError_t of the launches
// (0 on success).
extern "C" int seg_hist_launch(const void* binned, const void* perm,
                               const void* ch, const void* bounds,
                               void* scratch, void* out, long long stride,
                               int d, int M, int B, int warps, int group_rows,
                               int n_groups, int wide, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int err =
        wide ? launch_groups<true>(binned, perm, ch, bounds, scratch, stride,
                                   d, M, B, warps, group_rows, n_groups, st)
             : launch_groups<false>(binned, perm, ch, bounds, scratch,
                                    stride, d, M, B, warps, group_rows,
                                    n_groups, st);
    if (err != 0) return err;
    dim3 grid2((unsigned)((NCHAN * B * ((d + 3) / 4) + 255) / 256), M);
    const int width = (d + TILE - 1) / TILE * TILE;
    seg_hist_reduce<<<grid2, 256, 0, st>>>(
        (const float*)scratch, (const int32_t*)bounds, (float*)out, d,
        width, M, B, group_rows);
    return (int)cudaGetLastError();
}
