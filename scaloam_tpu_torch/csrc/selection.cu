// Greedy curvature feature selection, one thread block per ring row: sort
// each subregion's candidates once, then walk the sorted lists with warp
// ballots.
//
// Replaces the TPU kernel scaloam_tpu/ops/pallas/selection.py:select_features
// (body _make_kernel). Semantics per row: n_corner rounds, each taking the
// subregions s = 0..nsub-1 in order; a pick is the argmax of curv among
// eligible, unsuppressed points of [sp[s], ep[s]] with curv > thr (ties to
// the lowest index) and suppresses the band [j - left[j], j + right[j]]. Then
// n_flat rounds of argmin over curv < thr; the last flat round suppresses
// nothing. Corner picks set labels. A pick that finds nothing returns index 0,
// ok false. (The Pallas kernel's "found" test is max > -1e30; the wrapper
// requires |thr| < 1e30, where that equals "some candidate is left".)
//
// The Pallas kernel keeps a per-round candidate array `val` beside the
// suppression mask. Every band that strikes `val` also sets the mask (and the
// last flat round changes neither), so "eligible & not suppressed now &
// threshold" equals `val` at every pick: one flag byte per point suffices
// (1 = available, 0 = not eligible, 2 = suppressed).
//
// Bound on the card: ~2 MB moved at full width (64 x 2304), under 1 us at
// 3.35 TB/s. What limits it is the chain of 144 dependent picks per row.
// Design:
//  1. Sort (whole block, once). Every point gets a unique 64-bit key that
//     orders "corner candidates by (-curv, index)" and "flat candidates by
//     (curv, index)"; points that fail the threshold, NaNs and ineligible
//     points get key 0 and enter no list. Each subregion scatters its
//     candidates' keys into a corner and a flat segment (shared-memory
//     atomics); each segment entry is then ranked by counting the keys of
//     its segment above it, and its point index (carried in the key) lands
//     at that slot of the subregion's list. Subregions may overlap or be
//     empty: each owns segments as long as its clipped span, so a point may
//     sit in several lists.
//  2. Walk (warp 0 alone, no block barrier). The lanes form nsub groups of
//     G = 32 / nsub; group s holds, in registers, the G entries of
//     subregion s's list from its cursor with each entry's band. A round
//     reads every window's flags with one ballot and takes each group's
//     first entry with flag == 1 (__ffs of the group's bits); the winners
//     and their bands reach every lane by shuffle. A winner stands unless it
//     lies in the band of a lower subregion's winner of the same round
//     (register compares); then the groups are resolved in order, a ballot
//     each, and a window emptied by those bands slides on from fresh flags.
//     The round's bands are written at its end, then __syncwarp. A window
//     with no flag-1 entry slides G entries on. The cursor moves to the
//     winner: skipped entries are suppressed or ineligible for good, since
//     suppression only grows; the candidate set only shrinks, so the first
//     survivor in sorted order is the masked argmax with ties to the lowest
//     index. Lane p keeps round p's pick.
// A round's critical path is then one flag load, one ballot and a few
// shuffles for all subregions, not three block barriers per pick. It stays a
// single warp's latency chain: on an H100 a dependent shared-memory load
// costs ~50 cycles and a ballot + shuffle ~120 (tools/torch_kernel_probe.py).
// Rows are loaded with 16-byte vector loads where aligned; outputs are
// written once at the end.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSub = 8;
// n_corner, n_flat <= 32 (the wrapper checks): lane p keeps round p's pick.
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOrdNegInf = static_cast<int>(0x807fffffu);  // ord_f32(-inf)

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory layout of one row (byte offsets; every region 16-aligned).
struct Layout {
  size_t key, seg, list, band, flag, label, oci, ofi, total;
  __host__ __device__ Layout(int W, int nsub, int n_corner, int n_flat) {
    key = 0;
    seg = key + align16(8 * size_t(W));
    list = seg + align16(8 * size_t(nsub) * W);
    band = list + align16(2 * size_t(nsub) * W);
    flag = band + align16(4 * size_t(W));
    label = flag + align16(W);
    oci = label + align16(W);
    ofi = oci + align16(4 * size_t(nsub) * n_corner);
    total = ofi + align16(4 * size_t(nsub) * n_flat);
  }
};

// Order-preserving int of a non-NaN float (-0 taken as +0).
__device__ __forceinline__ int ord_f32(float c) {
  const int i = __float_as_int(c == 0.0f ? 0.0f : c);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// Sort key of one point: larger = earlier in its list. Corner keys exceed
// every flat key.
__device__ __forceinline__ unsigned long long point_key(float c, bool elig, int j,
                                                        float thr, int ord_thr) {
  if (!elig || !(c > thr || c < thr)) return 0ull;  // no list (NaN included)
  // corners: ord(c) > ord(thr); flats map into [ord(-inf), ord(thr) - 1],
  // smaller curv -> larger key.
  const int k = c > thr ? ord_f32(c)
                        : static_cast<int>(static_cast<long long>(ord_thr) - 1 +
                                           kOrdNegInf - ord_f32(c));
  const unsigned hi = static_cast<unsigned>(k) ^ 0x80000000u;
  return (static_cast<unsigned long long>(hi) << 32) | (0xffffffffu - static_cast<unsigned>(j));
}

__device__ __forceinline__ bool is_corner(unsigned long long key, int ord_thr) {
  return static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u) > ord_thr;
}

__global__ void __launch_bounds__(kThreads) select_kernel(
    const float* __restrict__ curv, const int* __restrict__ left,
    const int* __restrict__ right, const uint8_t* __restrict__ elig,
    const int* __restrict__ sp, const int* __restrict__ ep, int W, int nsub,
    int n_corner, int n_flat, float thr, int* __restrict__ corner_idx,
    uint8_t* __restrict__ corner_ok, int* __restrict__ flat_idx,
    uint8_t* __restrict__ flat_ok, uint8_t* __restrict__ labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(W, nsub, n_corner, n_flat);
  auto* s_key = reinterpret_cast<unsigned long long*>(smem + lay.key);
  auto* s_seg = reinterpret_cast<unsigned long long*>(smem + lay.seg);
  auto* s_list = reinterpret_cast<int16_t*>(smem + lay.list);
  auto* s_band = reinterpret_cast<int*>(smem + lay.band);  // lo | hi << 16
  auto* s_flag = smem + lay.flag;
  auto* s_label = smem + lay.label;
  auto* s_oci = reinterpret_cast<int*>(smem + lay.oci);
  auto* s_ofi = reinterpret_cast<int*>(smem + lay.ofi);
  __shared__ int s_lo[kMaxSub], s_base[kMaxSub + 1], s_nc[kMaxSub], s_nf[kMaxSub];

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * W;
  const int ord_thr = ord_f32(thr);

  // ---- load the row: key, suppression band and flag of every point
  auto put = [&](int j, float c, int l, int r, uint8_t e) {
    s_key[j] = point_key(c, e != 0, j, thr, ord_thr);
    const int lo = max(j - min(max(l, 0), W), 0);
    const int hi = min(j + min(max(r, 0), W), W - 1);
    s_band[j] = lo | (hi << 16);
    s_flag[j] = e ? 1 : 0;
    s_label[j] = 0;
  };
  const bool vec = (W % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(curv + off) | reinterpret_cast<uintptr_t>(left + off) |
                     reinterpret_cast<uintptr_t>(right + off)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(elig + off) & 3) == 0;
  if (vec) {
    for (int q = tid; q < W / 4; q += kThreads) {
      const float4 c = reinterpret_cast<const float4*>(curv + off)[q];
      const int4 l = reinterpret_cast<const int4*>(left + off)[q];
      const int4 r = reinterpret_cast<const int4*>(right + off)[q];
      const uchar4 e = reinterpret_cast<const uchar4*>(elig + off)[q];
      put(4 * q, c.x, l.x, r.x, e.x);
      put(4 * q + 1, c.y, l.y, r.y, e.y);
      put(4 * q + 2, c.z, l.z, r.z, e.z);
      put(4 * q + 3, c.w, l.w, r.w, e.w);
    }
  } else {
    for (int j = tid; j < W; j += kThreads)
      put(j, curv[off + j], left[off + j], right[off + j], elig[off + j]);
  }
  if (tid == 0) {
    int base = 0;
    for (int s = 0; s < nsub; ++s) {
      const int lo = max(sp[row * nsub + s], 0);
      const int hi = min(ep[row * nsub + s], W - 1);
      s_lo[s] = lo;
      s_base[s] = base;
      base += max(hi - lo + 1, 0);
      s_nc[s] = s_nf[s] = 0;
    }
    s_base[nsub] = base;
  }
  __syncthreads();

  // ---- sort: scatter each candidate's key into its subregion's corner
  // segment (from the front) or flat segment (from the back), then rank
  // every segment entry within its segment
  const int n_virtual = s_base[nsub];
  for (int v = tid; v < n_virtual; v += kThreads) {
    int s = 0;
    while (v >= s_base[s + 1]) ++s;
    const unsigned long long kj = s_key[s_lo[s] + (v - s_base[s])];
    if (kj == 0ull) continue;
    if (is_corner(kj, ord_thr))
      s_seg[s_base[s] + atomicAdd(&s_nc[s], 1)] = kj;
    else
      s_seg[s_base[s + 1] - 1 - atomicAdd(&s_nf[s], 1)] = kj;
  }
  __syncthreads();
  for (int u = tid; u < n_virtual; u += kThreads) {
    int s = 0;
    while (u >= s_base[s + 1]) ++s;
    const int nc = s_nc[s], b0 = s_base[s], b1 = s_base[s + 1];
    const bool corner = u < b0 + nc;
    if (!corner && u < b1 - s_nf[s]) continue;  // the gap between the segments
    const int k0 = corner ? b0 : b1 - s_nf[s];
    const int k1 = corner ? b0 + nc : b1;
    const unsigned long long ku = s_seg[u];
    int rank = 0;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) rank += s_seg[k] > ku;
    const int j = static_cast<int>(0xffffffffu - static_cast<unsigned>(ku));
    s_list[b0 + (corner ? 0 : nc) + rank] = static_cast<int16_t>(j);
  }
  __syncthreads();
  if (tid >= 32) return;

  // ---- the pick loop: warp 0 alone. Lanes form nsub groups of G = 32 /
  // nsub; group h holds subregion h's window: G list entries from its
  // cursor with their bands. A round tests every window's flags with one
  // ballot, takes each group's first available entry, and checks the
  // winners against lower groups' bands of the same round in registers;
  // only a conflict resolves the groups in order with a ballot each.
  const int lane = tid;
  const int G = 32 / nsub;
  const int g = lane / G;  // my subregion; g >= nsub: idle lane
  const int gi = lane - g * G;
  const bool active = g < nsub;
  const unsigned gmask = G == 32 ? kFull : (1u << G) - 1;
  int pick[kMaxSub];
  for (int phase = 0; phase < 2; ++phase) {
    const bool corner = phase == 0;
    const int rounds = corner ? n_corner : n_flat;
    const int start = active ? s_base[g] + (corner ? 0 : s_nc[g]) : 0;
    const int len = active ? (corner ? s_nc[g] : s_nf[g]) : 0;
    int cur = 0;
    int wj = gi < len ? s_list[start + gi] : -1;
    int wb = wj >= 0 ? s_band[wj] : 0;
#pragma unroll
    for (int h = 0; h < kMaxSub; ++h) pick[h] = -1;
    for (int p = 0; p < rounds; ++p) {
      const bool suppress = corner || p < n_flat - 1;
      bool ok = wj >= 0 && s_flag[wj] == 1;
      unsigned m = __ballot_sync(kFull, ok);
      for (;;) {  // slide on the windows that ran dry while their list goes on
        const bool slide = active && ((m >> (g * G)) & gmask) == 0 && cur + G < len;
        if (!__any_sync(kFull, slide)) break;
        if (slide) {
          cur += G;
          wj = cur + gi < len ? s_list[start + cur + gi] : -1;
          wb = wj >= 0 ? s_band[wj] : 0;
          ok = wj >= 0 && s_flag[wj] == 1;
        }
        m = __ballot_sync(kFull, ok);
      }
      // every group's first available entry (flags as of the round's start)
      int wl[kMaxSub], wjs[kMaxSub], wbs[kMaxSub];
#pragma unroll
      for (int h = 0; h < kMaxSub; ++h) {
        const unsigned f = h < nsub ? (m >> (h * G)) & gmask : 0u;
        wl[h] = f ? h * G + __ffs(f) - 1 : -1;
        wjs[h] = __shfl_sync(kFull, wj, max(wl[h], 0));
        wbs[h] = __shfl_sync(kFull, wb, max(wl[h], 0));
      }
      bool conflict = false;
      if (suppress) {
#pragma unroll
        for (int h = 1; h < kMaxSub; ++h)
#pragma unroll
          for (int e = 0; e < h; ++e)
            conflict |= wl[h] >= 0 && wl[e] >= 0 && wjs[h] >= (wbs[e] & 0xffff) &&
                        wjs[h] <= (wbs[e] >> 16);
      }
      if (conflict) {  // rare: resolve in order against the final lower picks
#pragma unroll
        for (int h = 1; h < kMaxSub; ++h) {
          if (h < nsub) {
            bool hit = false;
#pragma unroll
            for (int e = 0; e < h; ++e)
              hit |= wl[e] >= 0 && wj >= (wbs[e] & 0xffff) && wj <= (wbs[e] >> 16);
            unsigned f = (__ballot_sync(kFull, ok && !hit) >> (h * G)) & gmask;
            if (f == 0 && __shfl_sync(kFull, cur + G < len, h * G)) {
              // the window ran dry under this round's lower bands: write
              // them, then slide group h on from fresh flags
#pragma unroll
              for (int e = 0; e < h; ++e)
                if (wl[e] >= 0)
                  for (int b = (wbs[e] & 0xffff) + lane; b <= (wbs[e] >> 16); b += 32) s_flag[b] = 2;
              __syncwarp();
              while (f == 0 && __shfl_sync(kFull, cur + G < len, h * G)) {
                if (g == h) {
                  cur += G;
                  wj = cur + gi < len ? s_list[start + cur + gi] : -1;
                  wb = wj >= 0 ? s_band[wj] : 0;
                  ok = wj >= 0 && s_flag[wj] == 1;
                }
                f = (__ballot_sync(kFull, ok) >> (h * G)) & gmask;
              }
            }
            wl[h] = f ? h * G + __ffs(f) - 1 : -1;
            wjs[h] = __shfl_sync(kFull, wj, max(wl[h], 0));
            wbs[h] = __shfl_sync(kFull, wb, max(wl[h], 0));
          }
        }
      }
      int mine = -1;  // my group's winning lane
#pragma unroll
      for (int h = 0; h < kMaxSub; ++h) {
        if (lane == p && wl[h] >= 0) pick[h] = wjs[h];
        if (g == h) mine = wl[h];
        if (suppress && wl[h] >= 0)
          for (int b = (wbs[h] & 0xffff) + lane; b <= (wbs[h] >> 16); b += 32) s_flag[b] = 2;
      }
      cur = mine >= 0 ? cur + (mine - g * G) : len;  // to the winner, or spent
      __syncwarp();
      wj = cur + gi < len ? s_list[start + cur + gi] : -1;
      wb = wj >= 0 ? s_band[wj] : 0;
    }
    // lane p holds round p's picks: stage them (and the corner labels)
#pragma unroll
    for (int s = 0; s < kMaxSub; ++s) {
      if (s < nsub && lane < rounds) {
        (corner ? s_oci : s_ofi)[s * rounds + lane] = pick[s];
        if (corner && pick[s] >= 0) s_label[pick[s]] = 1;
      }
    }
  }
  __syncwarp();

  // ---- write the row's outputs once
  const int nci = nsub * n_corner, nfi = nsub * n_flat;
  for (int i = lane; i < nci; i += 32) {
    const int j = s_oci[i];
    corner_idx[row * nci + i] = max(j, 0);
    corner_ok[row * nci + i] = j >= 0;
  }
  for (int i = lane; i < nfi; i += 32) {
    const int j = s_ofi[i];
    flat_idx[row * nfi + i] = max(j, 0);
    flat_ok[row * nfi + i] = j >= 0;
  }
  if (W % 16 == 0 && (reinterpret_cast<uintptr_t>(labels + off) & 15) == 0) {
    for (int q = lane; q < W / 16; q += 32)
      reinterpret_cast<uint4*>(labels + off)[q] = reinterpret_cast<const uint4*>(s_label)[q];
  } else {
    for (int j = lane; j < W; j += 32) labels[off + j] = s_label[j];
  }
}

}  // namespace

extern "C" size_t scaloam_select_features_smem(int W, int nsub, int n_corner, int n_flat) {
  return Layout(W, nsub, n_corner, n_flat).total;
}

extern "C" int scaloam_select_features(
    const void* curv, const void* left, const void* right, const void* elig,
    const void* sp, const void* ep, int S, int W, int nsub, int n_corner,
    int n_flat, float thr, void* corner_idx, void* corner_ok, void* flat_idx,
    void* flat_ok, void* labels, void* stream) {
  const int smem = static_cast<int>(Layout(W, nsub, n_corner, n_flat).total);
  // Raise the kernel's dynamic shared-memory limit once per size (not on
  // every call, so launches can also be captured into a CUDA graph). Set it
  // even below 48 KB: static plus dynamic above 48 KB needs it too.
  static int smem_limit = 0;
  if (smem > smem_limit) {
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem;
  }
  select_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(curv), static_cast<const int*>(left),
      static_cast<const int*>(right), static_cast<const uint8_t*>(elig),
      static_cast<const int*>(sp), static_cast<const int*>(ep), W, nsub,
      n_corner, n_flat, thr, static_cast<int*>(corner_idx),
      static_cast<uint8_t*>(corner_ok), static_cast<int*>(flat_idx),
      static_cast<uint8_t*>(flat_ok), static_cast<uint8_t*>(labels));
  return static_cast<int>(cudaGetLastError());
}
