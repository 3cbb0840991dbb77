// PK1-PK7: the dependent-step probes. Each kernel runs `steps` iterations of
// one serial chain per lane and stores the final state, so that the time of
// two chain lengths gives the cost of one dependent step (the slope). They
// price in isolation what the entropy kernel K2 (entropy_decode.cu) does per
// symbol: a data-dependent table lookup, a variable shift, a compare-ladder
// step, a refill from a staged stream.
//
// They replace the Pallas kernels of benchmarks/pallas_gather_probe.py (E1-E6),
// pallas_gather_probe2.py (P1-P5), pallas_gather_probe3.py (G1-G4b) and
// pallas_gather_probe4.py (H1-H5). What is kept is the function each chain
// computes; the TPU's schedule is not: one lane is one thread, a "lane" or
// "sublane" gather is an indexed load, and the placement of a table (shared
// memory or global memory read through __ldg) is an argument, since that
// choice is K2's open question.
//
// What bounds them on the H100: neither bytes nor arithmetic throughput but
// the latency of the dependent instruction (a shared-memory load, an L1 or L2
// load, a shift, an asynchronous copy's round trip); a kernel here is right
// when it keeps that instruction on the chain and the compiler cannot fold
// it. Hence `steps` is a runtime argument, every chain's result is stored, and
// every next index depends on the loaded value.
//
// All arithmetic wraps modulo 2^32 as the JAX kernels' int32/uint32 does, so
// the state is held in uint32_t wherever a sum may overflow.
//
// The loads are not bounds-checked. Every index after the first is in range by
// the chain's modulus; the first is clamped into range once, before the chain,
// so that a caller's bad start cannot read outside the table (the host does
// not look at a device tensor's values: that would be a synchronisation in
// front of every launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// v mod `mod` for v >= 0: the scripts' `& 0xFFF` and `% size` are one
// function on non-negative operands; a power-of-two modulus takes the mask.
template <bool kPow2>
__device__ __forceinline__ int wrap(int v, int mod) {
  return kPow2 ? (v & (mod - 1)) : (v % mod);
}

// ---------------------------------------------------------------------------
// PK1 gather_chain: idx = (tab[base(lane) + idx * idx_stride] [+ idx] + i)
// mod `mod`. base = row * row_stride + col * col_stride with (row, col) the
// lane's position in the [n_lanes / lane_cols, lane_cols] index array, which
// expresses take (shared 1-D table: both strides 0), take_along_axis(axis=1)
// (row_stride = table width) and take_along_axis(axis=0) (col_stride = 1,
// idx_stride = table width). `size` is the table's extent along the axis.
// ---------------------------------------------------------------------------

template <bool kShared, bool kPow2>
__global__ void __launch_bounds__(kThreads)
gather_chain_kernel(const int* __restrict__ tab, const int* __restrict__ idx0,
                    int* __restrict__ out, int n_lanes, int lane_cols,
                    int row_stride, int col_stride, int idx_stride,
                    int tab_elems, int size, int add_idx, int mod, int steps) {
  extern __shared__ int s_tab[];
  if (kShared) {
    for (int k = threadIdx.x; k < tab_elems; k += blockDim.x) s_tab[k] = tab[k];
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int base = (lane / lane_cols) * row_stride + (lane % lane_cols) * col_stride;
  int idx = min(max(idx0[lane], 0), size - 1);
  for (int i = 0; i < steps; ++i) {
    const int at = base + idx * idx_stride;
    const int v = kShared ? s_tab[at] : __ldg(tab + at);
    idx = wrap<kPow2>(v + (add_idx ? idx : 0) + i, mod);
  }
  out[lane] = idx;
}

// ---------------------------------------------------------------------------
// PK2 onehot_lookup_chain: v = tab[idx >> bits][idx & (n - 1)], idx = (v +
// idx + i) & mask. On the TPU the lookup was a one-hot row times the table
// on the matrix unit and a masked row sum, because the matrix unit was its
// only gather; on Hopper it is a load of tab[hi][lo]. The table's entries
// are integers below 2^13, exact in float32 either way.
// ---------------------------------------------------------------------------

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
onehot_lookup_chain_kernel(const float* __restrict__ tab,
                           const int* __restrict__ idx0, int* __restrict__ out,
                           int n_lanes, int n, int bits, int mask, int steps) {
  extern __shared__ float s_ftab[];
  if (kShared) {
    for (int k = threadIdx.x; k < n * n; k += blockDim.x) s_ftab[k] = tab[k];
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  int idx = min(max(idx0[lane], 0), mask);
  for (int i = 0; i < steps; ++i) {
    const int at = (idx >> bits) * n + (idx & (n - 1));
    const int v = static_cast<int>(kShared ? s_ftab[at] : __ldg(tab + at));
    idx = (v + idx + i) & mask;
  }
  out[lane] = idx;
}

// ---------------------------------------------------------------------------
// PK3 row_scatter_chain: each step out[row][idx] += idx + i, idx = (idx + 7)
// mod width. Rows are independent, so a thread per row needs no atomics. The
// output starts from zero: a block first clears its rows.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
row_scatter_chain_kernel(const int* __restrict__ idx0, int* out, int n_rows,
                         int width, int steps) {
  const int row0 = blockIdx.x * blockDim.x;
  const int n_mine = min(static_cast<int>(blockDim.x), n_rows - row0) * width;
  int* mine = out + static_cast<int64_t>(row0) * width;
  for (int k = threadIdx.x; k < n_mine; k += blockDim.x) mine[k] = 0;
  __syncthreads();
  const int row = row0 + threadIdx.x;
  if (row >= n_rows) return;
  uint32_t* o = reinterpret_cast<uint32_t*>(out) + static_cast<int64_t>(row) * width;
  int idx = min(max(idx0[row], 0), width - 1);
  for (int i = 0; i < steps; ++i) {
    o[idx] += static_cast<uint32_t>(idx + i);
    idx = (idx + 7) % width;
  }
}

// ---------------------------------------------------------------------------
// PK4 vshift_chain: x = ((x >> ((sh + i + k) & 31)) ^ x) + 1 for k < n_ops,
// uint32, wrapping. The scripts unroll the n_ops operations of a step, which
// is what sets a step's fixed loop cost against the cost of one operation; so
// the count is a template constant (kOps), for the scripts' two: 1 and 10.
// ---------------------------------------------------------------------------

template <int kOps>
__global__ void __launch_bounds__(kThreads)
vshift_chain_kernel(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ sh0,
                    uint32_t* __restrict__ out, int n_lanes, int steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  uint32_t x = x0[lane];
  const uint32_t sh = sh0[lane];
  for (int i = 0; i < steps; ++i) {
#pragma unroll
    for (int k = 0; k < kOps; ++k) {
      x = ((x >> ((sh + static_cast<uint32_t>(i + k)) & 31u)) ^ x) + 1u;
    }
  }
  out[lane] = x;
}

// ---------------------------------------------------------------------------
// PK5 combined_step_chain: a decoder-like step per lane: a 12-bit peek of
// the bit buffer, a length from the table (its row 0: the script broadcasts
// that row to all eight), the shift, and when fewer than 16 bits are left a
// 16-bit refill from words[wordpos mod n_words][lane]. The script merges
// `shift_in >> (32 - sh)` with sh = 0 and shift_in = 0 when no refill is
// due; that value is 0, and it is written here without a shift by 32.
// ---------------------------------------------------------------------------

template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
combined_step_chain_kernel(const int* __restrict__ tab, const uint32_t* __restrict__ words,
                           int* __restrict__ out, int n_lanes, int tab_cols,
                           int n_words, int steps) {
  extern __shared__ int s_tab[];
  for (int k = threadIdx.x; k < tab_cols; k += blockDim.x) s_tab[k] = tab[k];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  uint32_t bitbuf = 0x9E3779B9u;
  int bitcnt = 32;
  int wordpos = 0;
  int acc = 0;
  for (int i = 0; i < steps; ++i) {
    const int e = s_tab[(bitbuf >> 20) & 0xFFF];
    const uint32_t ln = static_cast<uint32_t>(e) & 31u;
    bitbuf <<= ln;
    bitcnt -= static_cast<int>(ln);
    const bool need = bitcnt < 16;
    const uint32_t nxt =
        __ldg(words + static_cast<int64_t>(wrap<kPow2>(wordpos, n_words)) * n_lanes + lane);
    if (need) {
      bitbuf |= nxt >> 16;
      bitcnt += 16;
      wordpos += 1;
    }
    acc ^= e;
  }
  out[lane] = static_cast<int>(static_cast<uint32_t>(acc) + static_cast<uint32_t>(bitcnt) +
                               static_cast<uint32_t>(wordpos) + bitbuf);
}

// ---------------------------------------------------------------------------
// PK6 symbol_step_chain: K2's symbol step on [8, 128] lane state: a
// 16-threshold compare ladder (thresholds in shared memory), a 1024-entry
// lookup in two stages, EXTEND, variable shifts and a refill. The lookup is
// row = take_along_axis(sym, lo, 1); s = take_along_axis(row, hi, 0), i.e.
// s[r][c] = sym[hi[r][c]][lo[hi[r][c]][c]]: lane (r, c) needs the `lo` of
// lane (hi, c). A column's eight lanes are eight neighbouring threads of one
// warp here (thread = c * 8 + r), so that exchange is one __shfl_sync and
// needs no barrier.
// ---------------------------------------------------------------------------

constexpr int kSymRows = 8;
constexpr int kSymCols = 128;  // the offset's low 7 bits index a row

__global__ void __launch_bounds__(kThreads)
symbol_step_chain_kernel(const int* __restrict__ thr, const int* __restrict__ sym,
                         const uint32_t* __restrict__ bitbuf0,
                         const int* __restrict__ bitcnt0, const int* __restrict__ acc0,
                         int* __restrict__ out, int steps) {
  __shared__ int s_sym[kSymRows * kSymCols];
  __shared__ int s_thr[16];
  for (int k = threadIdx.x; k < kSymRows * kSymCols; k += blockDim.x) s_sym[k] = sym[k];
  if (threadIdx.x < 16) s_thr[threadIdx.x] = thr[threadIdx.x];
  __syncthreads();
  // The 1024 lanes fill the blocks exactly, so every warp is whole and the
  // full-mask shuffle is safe.
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = t & 7;
  const int c = t >> 3;
  const int at = r * kSymCols + c;
  uint32_t bitbuf = bitbuf0[at];
  int bitcnt = bitcnt0[at];
  int acc = acc0[at];
  const int column = threadIdx.x & 31 & ~7;  // this column's first lane of the warp
  for (int i = 0; i < steps; ++i) {
    const int code16 = static_cast<int>(bitbuf >> 16);
    int ln = 1;
#pragma unroll
    for (int l = 0; l < 16; ++l) ln += code16 > s_thr[l];
    ln = min(ln, 16);
    const int off = (code16 >> (16 - ln)) & 0x3FF;
    const int lo = off & 127;
    const int hi = (off >> 7) & 7;
    const int lo_of_hi = __shfl_sync(0xffffffffu, lo, column | hi);
    const int s = s_sym[hi * kSymCols + lo_of_hi];
    const int size = s & 0xF;
    const int ext = static_cast<int>(bitbuf >> (32 - ln - size)) & ((1 << size) - 1);
    const int half = size > 0 ? 1 << (size - 1) : 0;
    const int val = ext < half ? ext - 2 * half + 1 : ext;
    bitbuf <<= ln + size;
    bitcnt -= ln + size;
    if (bitcnt < 16) {
      bitbuf |= 0x5A5Au;
      bitcnt += 16;
    }
    acc ^= val;
  }
  out[at] = static_cast<int>(static_cast<uint32_t>(acc) + static_cast<uint32_t>(bitcnt) + bitbuf);
}

// ---------------------------------------------------------------------------
// PK7 dma_wave_chain: waves of 128 asynchronous copies of 8 rows x 64 int32
// (2 KB, contiguous) from stream[(off[c] + c) mod (n_rows - 8)] into slot
// c mod 16 of a [128][64] window in shared memory; wait; off += 1. The
// result is off + window[0][0].
//
// Hopper's counterpart of the per-lane DMA is cp.async here: 16-byte chunks,
// 128 of them per copy, four per thread of the warp that owns the slot. A
// 1-D cp.async.bulk with an mbarrier per slot would do as well; cp.async is
// taken because it needs no barrier object and these copies are small.
//
// Eight copies of a wave land in each slot, and the result is defined by
// issue order: the last one issued stays. cp.async gives no order between
// copies in flight, so the warp that owns a slot issues its first seven,
// waits for them, and then issues the eighth: 112 copies of a wave are in
// flight together, then 16.
// ---------------------------------------------------------------------------

constexpr int kSlots = 16;
constexpr int kSlotRows = 8;
constexpr int kRowInts = 64;
constexpr int kWaveCopies = 128;
constexpr int kSlotBytes = kSlotRows * kRowInts * 4;

__device__ __forceinline__ void copy_slot_async(int* slot, const int* src, int lane) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(slot));
  const char* from = reinterpret_cast<const char*>(src);
#pragma unroll
  for (int k = 0; k < kSlotBytes / 16 / 32; ++k) {
    const int chunk = (k * 32 + lane) * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + chunk),
                 "l"(from + chunk)
                 : "memory");
  }
}

__device__ __forceinline__ void wait_all_async() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kSlots * 32)
dma_wave_chain_kernel(const int* __restrict__ stream, const int* __restrict__ off0,
                      int* __restrict__ out, int n_rows, int waves) {
  __shared__ __align__(16) int window[kSlots * kSlotRows * kRowInts];
  __shared__ int off[kWaveCopies];
  const int slot = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kWaveCopies) off[threadIdx.x] = max(off0[threadIdx.x], 0);
  __syncthreads();
  int* mine = window + slot * kSlotRows * kRowInts;
  for (int w = 0; w < waves; ++w) {
    for (int c = slot; c < kWaveCopies; c += kSlots) {
      if (c + kSlots >= kWaveCopies) {  // the slot's last copy: after the others
        wait_all_async();
        __syncwarp();
      }
      const int row = (off[c] + c) % (n_rows - kSlotRows);
      copy_slot_async(mine, stream + static_cast<int64_t>(row) * kRowInts, lane);
    }
    wait_all_async();
    __syncthreads();
    if (threadIdx.x < kWaveCopies) off[threadIdx.x] += 1;
    __syncthreads();
  }
  if (threadIdx.x < kWaveCopies) {
    out[threadIdx.x] = static_cast<int>(static_cast<uint32_t>(off[threadIdx.x]) +
                                        static_cast<uint32_t>(window[0]));
  }
}

inline unsigned blocks_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// Dynamic shared memory above 48 KB needs the opt-in (up to 227 KB a block).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, unsigned blocks, unsigned threads, size_t shared,
           void* cuda_stream, Args... args) {
  const cudaError_t rc = allow_shared(kernel, shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<blocks, threads, shared, static_cast<cudaStream_t>(cuda_stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" int jdtc_probe_gather_chain(const void* tab, const void* idx0, void* out,
                                       int n_lanes, int lane_cols, int row_stride,
                                       int col_stride, int idx_stride, int tab_elems,
                                       int size, int add_idx, int mod, int steps, int in_shared,
                                       void* cuda_stream) {
  const size_t shared = in_shared ? static_cast<size_t>(tab_elems) * 4 : 0;
  auto go = [&](auto kernel) {
    return launch(kernel, blocks_for(n_lanes), kThreads, shared, cuda_stream,
                  static_cast<const int*>(tab), static_cast<const int*>(idx0),
                  static_cast<int*>(out), n_lanes, lane_cols, row_stride, col_stride,
                  idx_stride, tab_elems, size, add_idx, mod, steps);
  };
  if (in_shared) {
    return pow2(mod) ? go(gather_chain_kernel<true, true>)
                     : go(gather_chain_kernel<true, false>);
  }
  return pow2(mod) ? go(gather_chain_kernel<false, true>)
                   : go(gather_chain_kernel<false, false>);
}

extern "C" int jdtc_probe_onehot_lookup_chain(const void* tab, const void* idx0, void* out,
                                              int n_lanes, int n, int bits, int mask,
                                              int steps, int in_shared, void* cuda_stream) {
  const size_t shared = in_shared ? static_cast<size_t>(n) * n * 4 : 0;
  auto go = [&](auto kernel) {
    return launch(kernel, blocks_for(n_lanes), kThreads, shared, cuda_stream,
                  static_cast<const float*>(tab), static_cast<const int*>(idx0),
                  static_cast<int*>(out), n_lanes, n, bits, mask, steps);
  };
  return in_shared ? go(onehot_lookup_chain_kernel<true>)
                   : go(onehot_lookup_chain_kernel<false>);
}

extern "C" int jdtc_probe_row_scatter_chain(const void* idx0, void* out, int n_rows,
                                            int width, int steps, void* cuda_stream) {
  return launch(row_scatter_chain_kernel, blocks_for(n_rows), kThreads, 0, cuda_stream,
                static_cast<const int*>(idx0), static_cast<int*>(out), n_rows, width,
                steps);
}

extern "C" int jdtc_probe_vshift_chain(const void* x0, const void* sh0, void* out,
                                       int n_lanes, int n_ops, int steps,
                                       void* cuda_stream) {
  auto go = [&](auto kernel) {
    return launch(kernel, blocks_for(n_lanes), kThreads, 0, cuda_stream,
                  static_cast<const uint32_t*>(x0), static_cast<const uint32_t*>(sh0),
                  static_cast<uint32_t*>(out), n_lanes, steps);
  };
  if (n_ops == 1) return go(vshift_chain_kernel<1>);
  if (n_ops == 10) return go(vshift_chain_kernel<10>);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int jdtc_probe_combined_step_chain(const void* tab, const void* words, void* out,
                                              int n_lanes, int tab_cols, int n_words,
                                              int steps, void* cuda_stream) {
  const size_t shared = static_cast<size_t>(tab_cols) * 4;
  auto go = [&](auto kernel) {
    return launch(kernel, blocks_for(n_lanes), kThreads, shared, cuda_stream,
                  static_cast<const int*>(tab), static_cast<const uint32_t*>(words),
                  static_cast<int*>(out), n_lanes, tab_cols, n_words, steps);
  };
  return pow2(n_words) ? go(combined_step_chain_kernel<true>)
                       : go(combined_step_chain_kernel<false>);
}

extern "C" int jdtc_probe_symbol_step_chain(const void* thr, const void* sym,
                                            const void* bitbuf0, const void* bitcnt0,
                                            const void* acc0, void* out, int steps,
                                            void* cuda_stream) {
  static_assert(kSymRows * kSymCols % kThreads == 0, "whole blocks");
  return launch(symbol_step_chain_kernel, kSymRows * kSymCols / kThreads, kThreads, 0,
                cuda_stream, static_cast<const int*>(thr), static_cast<const int*>(sym),
                static_cast<const uint32_t*>(bitbuf0), static_cast<const int*>(bitcnt0),
                static_cast<const int*>(acc0), static_cast<int*>(out), steps);
}

extern "C" int jdtc_probe_dma_wave_chain(const void* stream, const void* off0, void* out,
                                         int n_rows, int waves, void* cuda_stream) {
  return launch(dma_wave_chain_kernel, 1, kSlots * 32, 0, cuda_stream,
                static_cast<const int*>(stream), static_cast<const int*>(off0),
                static_cast<int*>(out), n_rows, waves);
}
