// K3: nearest-neighbour chroma upsample + colour conversion + RGB store, 1,
// 3 or 4 components (gray, YCbCr, YCCK, raw Adobe CMYK); K3f: the same with
// fancy (triangular 2x) chroma upsampling, 3 or 4 components. One template,
// one thread per run of 16 output pixels of a row, one launch per request or
// batch (blockIdx.z is the image: the counterpart of jax.vmap over the stage
// in jpeg_decoder_tpu/parallel/batch.py _batched_stage), reading the uint8
// pixel planes K0, K1 or K5 wrote.
//
// K3 replaces the XLA half of jpeg_decoder_tpu/models/decoder.py
// build_stage_raw after the IDCT: ops/color.py nn_upsample (:44), then
// ycbcr_to_rgb (:138), ycck_to_rgb (:181), cmyk_to_rgb (:167) or
// gray_to_rgb, with _store_rgb and the REFERENCE gray width-stride shear.
// On 4 planes it is named K3c in the records (the 4-component branch,
// :146-160). K3f replaces build_stage_raw with upsample="fancy" (:94-96,
// :115-120): ops/color.py fancy_upsample (:73; fancy_h2x :53, fancy_v2x
// :64) of every component, then the colour transform. XLA fused each into
// one program; in plain PyTorch they are a dozen launches with float32
// temporaries in device memory. The colour arithmetic lives in color.cuh,
// shared with K03 (pixel_exact.cu) and K13 (pixel_float.cu), which run the
// 3-component nearest-neighbour EXACT and FLOAT32 paths in one kernel each
// with the IDCT; K3 serves every frame and geometry they do not take.
//
// Fancy upsampling is integer-exact. The JAX package computes in float32:
// a horizontal pass gives H = (3x + n + b) * 0.25 for source sample x and
// its left (even output, b = 1) or right (odd output, b = 2) neighbour n;
// the vertical pass the same over rows. Write A = 3x + n + b, an integer of
// at most 3*255 + 255 + 2 = 1022: H = A/4 is exact in float32, so one pass
// floors to A >> 2. After both passes the value is (3*H + H' + b') * 0.25
// = (3A + A' + 4b') / 16, with A and A' the horizontal sums of the source
// row and of its upper (even output row, b' = 1) or lower (odd, b' = 2)
// neighbour row: every intermediate is a multiple of 1/16 below 2^12,
// exact in float32's 24-bit significand, so the floor is (3A + A' + 4b')
// >> 4 in int32, bitwise the JAX function's. Its largest value, 4096/16 =
// 256 in an all-255 neighbourhood, is clamped to 255 before the store
// (ops/color.py:86-90).
//
// The neighbours: JAX rolls over the whole padded [rows, stride] plane and
// replicates the plane's first and last row and column, so the edges here
// are the PADDED plane's (rows - 1, stride - 1), not the image's or the
// component's x and y; a batch's images each have their own. A ratio that
// is not 2x (4:1:1's 4x) takes no pass on that axis, and the passes'
// output is then indexed by the reference's nearest-neighbour rule with
// the factors after the passes (eh / max_hsf, ev / max_vsf): `kNN` in a
// component's flags. A component at the full factors is read in place (no
// flag: the rule's index at ratio 1 is the pixel's own). A gray plane's
// stride is the image width under REFERENCE (the y_rgb shear,
// colour_conversion.c:20) and the padded plane's under CORRECT.
//
// Striped and streamed decode (K6n and K6f in the records; the XLA
// programs of jpeg_decoder_tpu/parallel/stripes.py make_chunk_stage :322
// and make_shard_fn :86) launch both over a chunk of MCU rows or over the
// whole padded frame, with the launch's first row of the padded frame and
// the stripe height: the nearest-neighbour rows then follow colour::nn_row.
// K3f there takes the triangular passes only for a component whose factors
// reach the maximum after them (stripes.py:139-144), and the
// nearest-neighbour rule at its own ratios for every other component (the
// host sets its flags so); on one card every stripe is resident, so the
// vertical pass over the padded plane's rows is the stripes' one-row halo
// exchange, the padded plane's last row its outer edge.
//
// K6h (jdtc_fancy_halo) is K3f over ONE stripe of a mesh's stripe axis,
// each rank holding its own stripe (parallel/stripes.py decode_striped
// with a mesh; the shard_map body of stripes.py:86 with the ppermute of
// :56). A component's vertical pass then reads its row -1 and its row
// `rows` from two halo rows the caller passes, its neighbours' edge rows
// that the ranks exchanged (or its own at the axis's ends): `vrow`. The
// horizontal pass is row-local, so the halo rows are the IDCT's uint8
// rows and the sums over them are the JAX program's floats, as above.
// Nothing else changes: the planes stay as K0 or K1 wrote them. What
// bounds it is K3f's; a stripe adds two rows a component.
//
// What bounds it on the H100: on paper memory (the planes in, three bytes
// a pixel out); in practice the instructions a pixel. A thread a pixel
// would take two 64-bit divisions for its row and column, compute every
// fancy chroma sample afresh in each of the four pixels that share its
// sources (six byte loads a component) and store three single bytes. So a
// thread takes a run of 16 output pixels of one row, j0 = 16 m to j0 + 15;
// the row, the run and the image come from the grid (blockDim 16 runs x 8
// rows). Every run brings each component's sources in as one vector: 16
// bytes in place, or for the 2x passes the 8 source bytes a run needs from
// each source row and their two edge neighbours, whose horizontal sums the
// run's pixels then share; the nearest-neighbour row is found once a run.
// The row's partial last run too: its loads stay inside the padded plane
// (fetch_vector), and its pixels past the row's end are not stored. Only a
// 4:1:1 or mixed ratio, or a plane not 8- or 16-byte aligned, takes each
// pixel's sample by the per-pixel rule (`sample`): a warp
// waits for its slowest lane, so one such run slows the 31 beside it. The
// colour arithmetic is color.cuh's, unchanged.
//
// The stores. A run's 48 RGB bytes start at the row's head (the address of
// the row's first RGB byte modulo 16: 48 m adds nothing to it). Where the
// head is 0 they go out as three aligned 16-byte stores, the partial run's
// valid pixels byte by byte: every row of an aligned launch (a width a
// multiple of 16 and an aligned output: 4K stills, aligned stripes) takes
// only this. Elsewhere (a 500-wide row is 1,500 bytes, 12 modulo 16, so
// the heads of its rows cycle 0, 12, 8, 4) the thread takes the first 16
// bytes of the next run from its lane's neighbour by a shuffle, and stores
// the three aligned 16-byte chunks that start `lead` = 16 - head bytes into
// its run: its own last 48 - lead bytes and the next run's first lead. The
// first run of the CTA's row segment (256 pixels) stores its first lead
// bytes byte by byte, and a chunk that would pass the segment's end (the
// next CTA's bytes, or the row's end) stores its bytes up to the end byte
// by byte: neighbouring CTAs write disjoint bytes. (Runs placed by the
// output instead, shifted by the row's head to store aligned, would start
// off the source's 16-pixel boundaries on three rows in four of a 500-wide
// batch, and take the per-pixel rule there.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace {

constexpr int kRun = 16;             // output pixels a thread
constexpr int kRunThreads = 16;      // runs a CTA along a row
constexpr int kRunRows = 8;          // rows a CTA
constexpr int kMaxComps = 4;
// A component's flags (ops/color.py upsample_geometry).
constexpr int kH2x = 1;  // a horizontal 2x pass
constexpr int kV2x = 2;  // a vertical 2x pass
constexpr int kNN = 4;   // then the nearest-neighbour rule (else read in place)

struct Geometry {
  const uint8_t* plane[kMaxComps];
  int64_t img_stride[kMaxComps];  // elements between one image's plane and the next
  int rows[kMaxComps];
  int stride[kMaxComps];
  int flags[kMaxComps];
  int local_rows[kMaxComps];  // plane rows a stripe (striped decode)
  float hratio[kMaxComps];
  float vratio[kMaxComps];
  int row0, stripe_h;  // striped decode: colour::nn_row; 0, 0 for whole frames
  // K6h: the rows above and below a one-image plane (null: its own edge rows)
  const uint8_t* halo[kMaxComps][2];
};

// Row t of component c's plane for the vertical pass, t in [-1, rows]:
// past the plane's edge the halo row given (K6h), else the plane's own
// edge row replicated.
__device__ __forceinline__ const uint8_t* vrow(const Geometry& g, const uint8_t* p, int c, int t,
                                               int cols) {
  if (t < 0) return g.halo[c][0] ? g.halo[c][0] : p;
  if (t >= g.rows[c])
    return g.halo[c][1] ? g.halo[c][1] : p + static_cast<int64_t>(g.rows[c] - 1) * cols;
  return p + static_cast<int64_t>(t) * cols;
}

// The horizontal pass's integer sum A = 3x + n + b at output column q of a
// source row (before the >> 2).
__device__ __forceinline__ int hsum(const uint8_t* row, int q, int cols) {
  const int s = q >> 1;
  const int n = (q & 1) ? min(s + 1, cols - 1) : max(s - 1, 0);
  return 3 * row[s] + row[n] + ((q & 1) ? 2 : 1);
}

// The sample of component c at output pixel (i, j).
template <bool kFancy>
__device__ __forceinline__ uint8_t sample(const Geometry& g, int64_t img, int c, int i,
                                          int j) {
  const uint8_t* p = g.plane[c] + img * g.img_stride[c];
  const int cols = g.stride[c];
  const int flags = g.flags[c];
  int r = i, q = j;
  if (flags & kNN) {
    r = colour::nn_row(i, g.vratio[c], g.row0, g.stripe_h, g.local_rows[c]);
    q = static_cast<int>(colour::nn_index(j, g.hratio[c]));
  }
  if (!kFancy || !(flags & (kH2x | kV2x))) return p[static_cast<int64_t>(r) * cols + q];
  if (!(flags & kV2x)) return static_cast<uint8_t>(hsum(p + static_cast<int64_t>(r) * cols, q, cols) >> 2);
  const int t = r >> 1;
  const int bv = (r & 1) ? 2 : 1;
  const uint8_t* row = p + static_cast<int64_t>(t) * cols;
  const uint8_t* nrow = vrow(g, p, c, (r & 1) ? t + 1 : t - 1, cols);
  if (!(flags & kH2x)) return static_cast<uint8_t>((3 * row[q] + nrow[q] + bv) >> 2);
  const int v = (3 * hsum(row, q, cols) + hsum(nrow, q, cols) + 4 * bv) >> 4;
  return static_cast<uint8_t>(min(v, 255));
}

// 16 samples of one component for a run: sample k in byte k & 3 of w[k >> 2].
struct Run16 {
  uint32_t w[4];
};

__device__ __forceinline__ uint32_t byte_at(const Run16& r, int k) {
  return (r.w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

__device__ __forceinline__ uint32_t byte_of(uint2 v, int m) {
  return ((m < 4 ? v.x : v.y) >> (8 * (m & 3))) & 0xFFu;
}

// The horizontal sums A = 3x + n + b of a run's 16 output columns q = j0 +
// k (j0 even, s0 = j0 / 2): x = X[k / 2], n its left (even k, b = 1) or
// right (odd k, b = 2) neighbour, with X[m] = byte m of `mid` for m in
// [0, 8), X[-1] = left, X[8] = right (the edge-clamped neighbours).
__device__ __forceinline__ void hsums(uint2 mid, uint32_t left, uint32_t right, int* a) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int m = k >> 1;
    const int x = static_cast<int>(byte_of(mid, m));
    const int n = (k & 1) ? (m == 7 ? static_cast<int>(right) : static_cast<int>(byte_of(mid, m + 1)))
                          : (m == 0 ? static_cast<int>(left) : static_cast<int>(byte_of(mid, m - 1)));
    a[k] = 3 * x + n + ((k & 1) ? 2 : 1);
  }
}

__device__ __forceinline__ void pack16(const int* v, Run16& out) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out.w[q] = static_cast<uint32_t>(v[4 * q]) | (static_cast<uint32_t>(v[4 * q + 1]) << 8) |
               (static_cast<uint32_t>(v[4 * q + 2]) << 16) |
               (static_cast<uint32_t>(v[4 * q + 3]) << 24);
}

__device__ __forceinline__ void load16(const uint8_t* p, Run16& out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  out.w[0] = v.x;
  out.w[1] = v.y;
  out.w[2] = v.z;
  out.w[3] = v.w;
}

// Component c's 16 samples of the run at output row i, columns j0..j0+15,
// by vector loads; false where the component's geometry or its plane's
// alignment has no vector form (the caller then takes fetch_pixels). The
// caller guarantees j0 % 16 == 0 and j0 < w; the reads then stay inside the
// row, the row's partial last run included: where the alignment allows a
// vector form, the output columns the row covers (its stride, twice that
// under an H pass or a ratio of 1/2 across) are a multiple of 16 and at
// least w (upsample_geometry's bounds), so at least j0 + 16. A partial
// run's pixels past w are computed from the padded plane and not stored.
template <bool kFancy>
__device__ __forceinline__ bool fetch_vector(const Geometry& g, int img, int c, int i, int j0,
                                             Run16& out) {
  const uint8_t* p = g.plane[c] + img * g.img_stride[c];
  const int cols = g.stride[c];
  const int flags = g.flags[c];
  const uint32_t align = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p)) |
                         static_cast<uint32_t>(cols) |
                         static_cast<uint32_t>(reinterpret_cast<uintptr_t>(g.halo[c][0])) |
                         static_cast<uint32_t>(reinterpret_cast<uintptr_t>(g.halo[c][1]));
  if (flags == 0) {  // read in place
    if (align & 15) return false;
    load16(p + static_cast<int64_t>(i) * cols + j0, out);
    return true;
  }
  if (flags == kNN) {
    const float hr = g.hratio[c];
    if (!(hr == 1.0f && !(align & 15)) && !(hr == 0.5f && !(align & 7))) return false;
    const int r = colour::nn_row(i, g.vratio[c], g.row0, g.stripe_h, g.local_rows[c]);
    const uint8_t* row = p + static_cast<int64_t>(r) * cols;
    if (hr == 1.0f) {
      load16(row + j0, out);
    } else {  // (uint32)(j * 0.5f) = j >> 1, exactly: each source byte twice
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + (j0 >> 1)));
      out.w[0] = __byte_perm(v.x, 0, 0x1100);
      out.w[1] = __byte_perm(v.x, 0, 0x3322);
      out.w[2] = __byte_perm(v.y, 0, 0x1100);
      out.w[3] = __byte_perm(v.y, 0, 0x3322);
    }
    return true;
  }
  if (!kFancy) return false;
  if (flags == kV2x) {  // (3 row[q] + nrow[q] + bv) >> 2
    if (align & 15) return false;
    const int t = i >> 1;
    const int bv = (i & 1) ? 2 : 1;
    Run16 x, y;
    load16(p + static_cast<int64_t>(t) * cols + j0, x);
    load16(vrow(g, p, c, (i & 1) ? t + 1 : t - 1, cols) + j0, y);
    int v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = (3 * static_cast<int>(byte_at(x, k)) + static_cast<int>(byte_at(y, k)) + bv) >> 2;
    pack16(v, out);
    return true;
  }
  if (flags != kH2x && flags != (kH2x | kV2x)) return false;
  if (align & 7) return false;
  const int s0 = j0 >> 1;
  const int left = max(s0 - 1, 0);
  const int right = min(s0 + 8, cols - 1);
  if (flags == kH2x) {  // A >> 2 of the row itself
    const uint8_t* row = p + static_cast<int64_t>(i) * cols;
    int a[16];
    hsums(__ldg(reinterpret_cast<const uint2*>(row + s0)), row[left], row[right], a);
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] >>= 2;
    pack16(a, out);
    return true;
  }
  // both passes: (3 A + A' + 4 bv) >> 4 over source row t and its
  // neighbour tn, clamped to 255 (an all-255 neighbourhood gives 256)
  const int t = i >> 1;
  const int bv = (i & 1) ? 2 : 1;
  const uint8_t* row = p + static_cast<int64_t>(t) * cols;
  const uint8_t* nrow = vrow(g, p, c, (i & 1) ? t + 1 : t - 1, cols);
  int a[16], an[16];
  hsums(__ldg(reinterpret_cast<const uint2*>(row + s0)), row[left], row[right], a);
  hsums(__ldg(reinterpret_cast<const uint2*>(nrow + s0)), nrow[left], nrow[right], an);
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = min((3 * a[k] + an[k] + 4 * bv) >> 4, 255);
  pack16(a, out);
  return true;
}

// Component c's samples of the run by the per-pixel rule,
// each column clamped below w (a partial run's outside pixels are
// computed and not stored). The bytes shift in from the top, so the loop
// needs no register indexed at run time.
template <bool kFancy>
__device__ __forceinline__ void fetch_pixels(const Geometry& g, int img, int c, int i, int j0,
                                             int w, Run16& out) {
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll 1
  for (int k = 0; k < 16; ++k) {
    const int j = min(j0 + k, w - 1);
    const uint32_t v = sample<kFancy>(g, img, c, i, j);
    w0 = __funnelshift_r(w0, w1, 8);
    w1 = __funnelshift_r(w1, w2, 8);
    w2 = __funnelshift_r(w2, w3, 8);
    w3 = __funnelshift_r(w3, v, 8);
  }
  out.w[0] = w0;
  out.w[1] = w1;
  out.w[2] = w2;
  out.w[3] = w3;
}

// Byte b of the words v (b known at compile time).
__device__ __forceinline__ uint8_t byte_of_words(const uint32_t* v, int b) {
  return static_cast<uint8_t>(v[b >> 2] >> (8 * (b & 3)));
}

// Store a run's 48 RGB bytes `o` at dst, `head` (1-15) bytes past a
// 16-byte boundary, by aligned 16-byte chunks: bytes [lead, lead + 48) of o
// followed by the next run's first 16 bytes `nx` (lead = 16 - head). The
// thread writes only the `lim` bytes from dst on: a chunk that passes them
// goes out byte by byte up to lim. `first`: also o's bytes [0, lead), which
// no other run's chunk covers.
__device__ __forceinline__ void store_shifted(uint8_t* dst, int head, const uint32_t* o,
                                              const uint32_t* nx, int lim, bool first) {
  const int lead = 16 - head;
  uint32_t x[16];
#pragma unroll
  for (int k = 0; k < 12; ++k) x[k] = o[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[12 + k] = nx[k];
  // shift by whole words, then by lead & 3 bytes: x[k] = bytes 4k + lead..
  if (lead & 8) {
#pragma unroll
    for (int k = 0; k < 14; ++k) x[k] = x[k + 2];
  }
  if (lead & 4) {
#pragma unroll
    for (int k = 0; k < 13; ++k) x[k] = x[k + 1];
  }
  const uint32_t sh = 8u * static_cast<uint32_t>(lead & 3);
  uint32_t r[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = __funnelshift_r(x[k], x[k + 1], sh);
  if (first) {
#pragma unroll
    for (int b = 0; b < 15; ++b)
      if (b < lead && b < lim) dst[b] = byte_of_words(o, b);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int b0 = lead + 16 * q;
    if (b0 + 16 <= lim) {
      *reinterpret_cast<uint4*>(dst + b0) = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                                                       r[4 * q + 3]);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (b0 + b < lim) dst[b0 + b] = byte_of_words(r, 16 * q + b);
    }
  }
}

// The 48 RGB bytes of run j0..j0+15 of row i of image img, into o.
template <bool kFancy, int kMode>
__device__ __forceinline__ void convert_run(const Geometry& g, int img, int i, int j0, int w,
                                            int correct, uint32_t* o) {
  constexpr int kComps = kMode == colour::kGray ? 1 : (kMode == colour::kYCbCr ? 3 : 4);
  Run16 s[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c)
    if (!fetch_vector<kFancy>(g, img, c, i, j0, s[c]))
      fetch_pixels<kFancy>(g, img, c, i, j0, w, s[c]);
#pragma unroll
  for (int q = 0; q < 12; ++q) o[q] = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    uint8_t px[kMaxComps] = {};
#pragma unroll
    for (int c = 0; c < kComps; ++c) px[c] = static_cast<uint8_t>(byte_at(s[c], k));
    uint8_t rgb[3];
    colour::convert(kMode, px, correct, rgb);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      o[(3 * k + ch) >> 2] |= static_cast<uint32_t>(rgb[ch]) << (8 * ((3 * k + ch) & 3));
  }
}

// A run's 48 RGB bytes o at a 16-byte boundary: three aligned 16-byte
// stores, or where the row's end cuts the run its valid pixels byte by byte.
__device__ __forceinline__ void store_aligned(uint8_t* dst, const uint32_t* o, int j0, int w) {
  if (j0 + kRun <= w) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      reinterpret_cast<uint4*>(dst)[q] = make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2],
                                                    o[4 * q + 3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (j0 + k >= w) continue;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) dst[3 * k + ch] = byte_of_words(o, 3 * k + ch);
  }
}

// The design: thread (x, y) of CTA (bx, by, img) converts run bx * 16 + x,
// pixels j0 = 16 (bx * 16 + x) to j0 + 15, of output row by * 8 + y of
// image img (see the top of the file). A warp holds two rows' runs of one
// CTA, lane x + 1 the next run of lane x's row for x < 15. One kernel per
// (upsampling, colour mode): a mode fixed at compile time keeps YCCK
// EXACT's float64 registers out of the YCbCr and gray kernels (a runtime
// switch cost K3 9% on 4K 4:2:0 planes, PERF.md).
template <bool kFancy, int kMode>
__global__ void __launch_bounds__(kRunThreads * kRunRows)
colour_run_kernel(Geometry g, int h, int w, int correct, uint8_t* __restrict__ out) {
  const int i = static_cast<int>(blockIdx.y) * kRunRows + static_cast<int>(threadIdx.y);
  const int img = static_cast<int>(blockIdx.z);
  const int j0 = (static_cast<int>(blockIdx.x) * kRunThreads + static_cast<int>(threadIdx.x)) *
                 kRun;
  const bool live = i < h && j0 < w;
  uint32_t o[12];  // the run's 48 RGB bytes
  // Every row's head is 0 (uniform over the launch): no run needs its
  // neighbour's bytes.
  if (w % kRun == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    if (!live) return;
    convert_run<kFancy, kMode>(g, img, i, j0, w, correct, o);
    store_aligned(out + ((static_cast<int64_t>(img) * h + i) * w + j0) * 3, o, j0, w);
    return;
  }
  if (live) {
    convert_run<kFancy, kMode>(g, img, i, j0, w, correct, o);
  } else {
#pragma unroll
    for (int q = 0; q < 12; ++q) o[q] = 0;
  }
  uint32_t nx[4];  // the next run's first 16 bytes: every lane takes part
#pragma unroll
  for (int q = 0; q < 4; ++q) nx[q] = __shfl_down_sync(0xFFFFFFFFu, o[q], 1);
  if (!live) return;
  uint8_t* dst = out + ((static_cast<int64_t>(img) * h + i) * w + j0) * 3;
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  if (head == 0) {
    store_aligned(dst, o, j0, w);
    return;
  }
  // the bytes to the end of the CTA's row segment
  const int seg_end = min(w, (static_cast<int>(blockIdx.x) + 1) * kRunThreads * kRun);
  store_shifted(dst, head, o, nx, 3 * (seg_end - j0), threadIdx.x == 0);
}

template <bool kFancy, int kMode>
void run(const Geometry& g, int n_images, int h, int w, int correct, void* out,
         void* cuda_stream) {
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  const int runs = (w + kRun - 1) / kRun;  // a row's runs
  const dim3 blocks(static_cast<unsigned>((runs + kRunThreads - 1) / kRunThreads),
                    static_cast<unsigned>((h + kRunRows - 1) / kRunRows),
                    static_cast<unsigned>(n_images));
  colour_run_kernel<kFancy, kMode><<<blocks, dim3(kRunThreads, kRunRows), 0, stream>>>(
      g, h, w, correct, static_cast<uint8_t*>(out));
}

template <bool kFancy>
int launch(const void* plane0, const void* plane1, const void* plane2, const void* plane3,
           int n_images, int n_comps, int h, int w, const void* geom, const void* ratios,
           int row0, int stripe_h, int mode, int correct, const void* halos, void* out,
           void* cuda_stream) {
  // geom: host int64 [4][5], per component (image stride, rows, stride,
  // flags, plane rows a stripe); ratios: host float [4][2], per component
  // (hratio, vratio); halos: null, or host int64 [4][2], per component the
  // device addresses of its top and bottom halo rows (0: none), one image.
  const auto* gm = static_cast<const int64_t*>(geom);
  const auto* rt = static_cast<const float*>(ratios);
  const auto* hl = static_cast<const int64_t*>(halos);
  if (hl && n_images != 1) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{{static_cast<const uint8_t*>(plane0), static_cast<const uint8_t*>(plane1),
              static_cast<const uint8_t*>(plane2), static_cast<const uint8_t*>(plane3)}};
  for (int c = 0; c < kMaxComps; ++c) {
    g.img_stride[c] = gm[5 * c];
    g.rows[c] = static_cast<int>(gm[5 * c + 1]);
    g.stride[c] = static_cast<int>(gm[5 * c + 2]);
    g.flags[c] = static_cast<int>(gm[5 * c + 3]);
    g.local_rows[c] = static_cast<int>(gm[5 * c + 4]);
    g.hratio[c] = rt[2 * c];
    g.vratio[c] = rt[2 * c + 1];
    for (int e = 0; e < 2; ++e)
      g.halo[c][e] = hl ? reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(hl[2 * c + e]))
                        : nullptr;
  }
  g.row0 = row0;
  g.stripe_h = stripe_h;
  // the mode fixes the component count
  const int comps = mode == colour::kGray ? 1 : (mode == colour::kYCbCr ? 3 : 4);
  if (n_comps != comps) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case colour::kYCbCr: run<kFancy, colour::kYCbCr>(g, n_images, h, w, correct, out, cuda_stream); break;
    case colour::kYcckExact: run<kFancy, colour::kYcckExact>(g, n_images, h, w, correct, out, cuda_stream); break;
    case colour::kYcckFloat: run<kFancy, colour::kYcckFloat>(g, n_images, h, w, correct, out, cuda_stream); break;
    case colour::kCmyk: run<kFancy, colour::kCmyk>(g, n_images, h, w, correct, out, cuda_stream); break;
    case colour::kGray: run<kFancy, colour::kGray>(g, n_images, h, w, correct, out, cuda_stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 (K3c on 4 planes): nearest-neighbour upsampling, 1, 3 or 4 components.
extern "C" int jdtc_color(const void* plane0, const void* plane1, const void* plane2,
                          const void* plane3, int n_images, int n_comps, int h, int w,
                          const void* geom, const void* ratios, int row0, int stripe_h,
                          int mode, int correct, void* out, void* cuda_stream) {
  return launch<false>(plane0, plane1, plane2, plane3, n_images, n_comps, h, w, geom, ratios,
                       row0, stripe_h, mode, correct, nullptr, out, cuda_stream);
}

// K3f: fancy upsampling, 3 or 4 components.
extern "C" int jdtc_fancy(const void* plane0, const void* plane1, const void* plane2,
                          const void* plane3, int n_images, int n_comps, int h, int w,
                          const void* geom, const void* ratios, int row0, int stripe_h,
                          int mode, int correct, void* out, void* cuda_stream) {
  return launch<true>(plane0, plane1, plane2, plane3, n_images, n_comps, h, w, geom, ratios,
                      row0, stripe_h, mode, correct, nullptr, out, cuda_stream);
}

// K6h: K3f over one stripe of a mesh, its halo rows given.
extern "C" int jdtc_fancy_halo(const void* plane0, const void* plane1, const void* plane2,
                               const void* plane3, int n_images, int n_comps, int h, int w,
                               const void* geom, const void* ratios, int row0, int stripe_h,
                               int mode, int correct, const void* halos, void* out,
                               void* cuda_stream) {
  return launch<true>(plane0, plane1, plane2, plane3, n_images, n_comps, h, w, geom, ratios,
                      row0, stripe_h, mode, correct, halos, out, cuda_stream);
}
