// seg_hist — one tree level's per-channel gradient histograms, for Hopper.
//
// Replaces the TPU kernel transmogrifai_tpu/models/gbdt_kernels.py
// `_seg_kernel` (launched by `_seg_level_hists`, over the sort-and-pad row
// layout of `_seg_align`).  It computes
//
//     out[c][m][b][j] = sum_i ch_c[i] * [slot_i == m] * [binned[i][j] == b]
//
// for c < NCHAN = 2 (gradient, hessian of the binary objective), m < M,
// b < B, j < d, in float32, with exact zeros for slots that hold no rows.
//
// Layout (built by the wrapper with torch ops, no host synchronisation):
//   perm      (N,)  int32   row ids sorted by slot (stable sort)
//   ch        (N, 2) float32 channels gathered into that sorted order
//   counts    (M,)  int32   rows per slot
//   row_off   (M,)  int32   first sorted position of each slot
//   group_off (M+1,) int32  first row group of each slot; a slot of c rows
//                           owns ceil(c / R) groups of at most R rows, so a
//                           group never straddles two slots
// The binned matrix is NOT gathered into sorted order: the kernel reads
// binned[perm[r]][j] through the index (a sorted copy costs a full extra
// pass over the N x d matrix per level).
//
// Kernel 1 (seg_hist_groups): block = (row
// group g, feature tile of T=128 columns).  Thread j owns column j0+j of the
// tile and keeps its column of the [NCHAN][B][T] shared-memory histogram; it
// walks the group's rows in order, UNROLL rows a batch, and issues the next
// batch's loads (row ids, bins, channel values into registers) before the
// adds of the current one.  No two threads touch one address, so there are
// no atomics and the order of every sum is fixed.  The block writes its
// partial histogram to scratch[g].  Kernel 2 (seg_hist_reduce) sums each
// slot's groups in group order, in double, into out, writing zeros for
// empty slots.  Both passes have a fixed summation order: the result is
// bitwise identical from launch to launch, so split ties in the gain search
// cannot flip between runs.  A row group of R=1024 rows keeps each float32
// partial short (about R/B adds per bin) and gives ~1000 groups x 4 tiles
// = ~3900 blocks at M=1, 1M x 500.
//
// Bound: the function must read binned (N*d bytes), slot (4 bytes a row)
// and the channels (4*NCHAN bytes a row) once and write out
// (M*NCHAN*B*d*4 bytes).  At N=1M, d=500, B=32, M=32 that is
// ~0.52 GB, ~0.15 ms at an H100 SXM's 3.35 TB/s (divide by the card's own
// rate); the arithmetic (N*d*NCHAN adds) is far below the float32 rate, so
// the function is bound by bytes.  This design reads binned exactly once
// (gathered row segments of T bytes), adds the layout (a sort of the
// slots and a gather of the channels, ~16 bytes a row) and the scratch
// round trip (n_groups*NCHAN*B*d*4 bytes written and read back, ~125 MB at
// R=1024).  What it does not yet do: each thread reads one byte a row and
// its shared-memory read-modify-writes form one serial chain, so it runs
// far from the bound; wider loads per thread (several columns a thread),
// TMA row staging and fusing the layout sort are the next steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;     // feature-tile width == threads per block
constexpr int UNROLL = 8;  // rows a thread loads per batch
constexpr int NCHAN = 2;   // channels: gradient, hessian

// One batch of UNROLL sorted rows from position r: each row's bin in this
// thread's column and its NCHAN channel values, all loads issued together.
// Rows at or past r1 read as bin 255 (>= B, never counted).
__device__ __forceinline__ void load_batch(
        const uint8_t* __restrict__ binned, const int32_t* __restrict__ perm,
        const float* __restrict__ ch, int r, int r1, int d, int col,
        uint8_t (&bins)[UNROLL], float (&vals)[UNROLL][NCHAN]) {
    int rid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
        rid[u] = r + u < r1 ? __ldg(perm + r + u) : -1;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const bool in = rid[u] >= 0;
        bins[u] = in ? __ldg(binned + (size_t)rid[u] * d + col) : 255;
#pragma unroll
        for (int c = 0; c < NCHAN; ++c)
            vals[u][c] = in ? __ldg(ch + (size_t)(r + u) * NCHAN + c) : 0.0f;
    }
}

__global__ void seg_hist_groups(const uint8_t* __restrict__ binned,
                                const int32_t* __restrict__ perm,
                                const float* __restrict__ ch,
                                const int32_t* __restrict__ counts,
                                const int32_t* __restrict__ row_off,
                                const int32_t* __restrict__ group_off,
                                float* __restrict__ scratch,
                                int d, int M, int B, int R) {
    extern __shared__ float hist[];  // [NCHAN][B][T]
    const int g = blockIdx.x;
    const int n_groups = group_off[M];
    if (g >= n_groups) return;
    // slot s owning group g: last s with group_off[s] <= g
    int lo = 0, hi = M;  // invariant: group_off[lo] <= g < group_off[hi]
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (group_off[mid] <= g) lo = mid; else hi = mid;
    }
    const int s = lo;
    const int r0 = row_off[s] + (g - group_off[s]) * R;
    const int r1 = min(r0 + R, row_off[s] + counts[s]);

    const int j = threadIdx.x;
    const int col = blockIdx.y * T + j;
    if (col >= d) return;  // no barrier below: each thread owns its column
    for (int k = 0; k < NCHAN * B; ++k) hist[k * T + j] = 0.0f;
    // The next batch's loads are issued before this batch's adds, so the
    // gathered reads overlap the shared-memory read-modify-write chain.
    uint8_t bins[UNROLL];
    float vals[UNROLL][NCHAN];
    load_batch(binned, perm, ch, r0, r1, d, col, bins, vals);
    for (int r = r0; r < r1; r += UNROLL) {
        uint8_t nbins[UNROLL];
        float nvals[UNROLL][NCHAN];
        load_batch(binned, perm, ch, r + UNROLL, r1, d, col, nbins, nvals);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int b = bins[u];
            if (b < B) {
#pragma unroll
                for (int c = 0; c < NCHAN; ++c)
                    hist[(c * B + b) * T + j] += vals[u][c];
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            bins[u] = nbins[u];
#pragma unroll
            for (int c = 0; c < NCHAN; ++c) vals[u][c] = nvals[u][c];
        }
    }
    float* dst = scratch + (size_t)g * NCHAN * B * d + col;
    for (int k = 0; k < NCHAN * B; ++k) dst[(size_t)k * d] = hist[k * T + j];
}

__global__ void seg_hist_reduce(const float* __restrict__ scratch,
                                const int32_t* __restrict__ group_off,
                                float* __restrict__ out,
                                int d, int M, int B) {
    const int m = blockIdx.y;
    const size_t per_group = (size_t)NCHAN * B * d;
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= per_group) return;
    const int c = (int)(e / ((size_t)B * d));
    const size_t bj = e % ((size_t)B * d);
    // double across groups: a slot's group partials can be large while
    // their sum is near 0; one rounding at the end keeps the result within
    // the float32 tolerance of the exact sum at a million rows
    double acc = 0.0;
    for (int g = group_off[m]; g < group_off[m + 1]; ++g)
        acc += (double)scratch[g * per_group + e];
    out[((size_t)c * M + m) * B * d + bj] = (float)acc;
}

}  // namespace

// Launches both passes on `stream`.  `max_groups` bounds the row groups
// (ceil(N/R) + M) and sizes the grid; blocks past group_off[M] exit.  The
// caller keeps NCHAN*B*T*4 bytes within a block's shared memory (B <= 227)
// and M within gridDim.y (M <= 65535).  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int seg_hist_launch(const void* binned, const void* perm,
                               const void* ch, const void* counts,
                               const void* row_off, const void* group_off,
                               void* scratch, void* out,
                               int d, int M, int B, int R, int max_groups,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int smem = NCHAN * B * T * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        seg_hist_groups, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(max_groups, (d + T - 1) / T);
    seg_hist_groups<<<grid, T, smem, st>>>(
        (const uint8_t*)binned, (const int32_t*)perm, (const float*)ch,
        (const int32_t*)counts, (const int32_t*)row_off,
        (const int32_t*)group_off, (float*)scratch, d, M, B, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t per_group = (size_t)NCHAN * B * d;
    dim3 grid2((unsigned)((per_group + 255) / 256), M);
    seg_hist_reduce<<<grid2, 256, 0, st>>>(
        (const float*)scratch, (const int32_t*)group_off, (float*)out, d, M,
        B);
    return (int)cudaGetLastError();
}
