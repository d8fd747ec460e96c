// The 10M harness's corpus rows from their ids, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX harness (tools/bench_10m.py:164-222)
// draws each row with jax.random from fold_in(key(42), id), which XLA
// compiles. The port makes the same rows (bench/threefry.py, whose
// latent_rows_plain is this kernel's plain version) and, on the card,
// writes them here in one pass: per row, the key fold_in(base, id) and its
// subkeys (realistic: cluster, noise, radial; clustered: cluster, noise),
// the cluster draw (JAX's _randint: two draws folded into the span), the
// radial draw exp(0.25 n) and D normals, each from one Threefry-2x32 hash
// of (0, column) under the noise key:
//     realistic  out[r][j] = (centers[c][j] + (n_j * sigma) * spectrum[j]) * radial
//     clustered  out[r][j] = centers[c][j] + n_j * sigma
// A normal is sqrt(2) * erfinv(u), u uniform on [nextafter(-1, 0), 1) from
// the top 23 bits, erfinv XLA's f32 polynomial with its Horner steps as
// fused multiply-adds; the other steps round one by one (__fmul_rn,
// __fadd_rn; the library is built with -fmad=false), as the plain version
// does. The rotation and the normalisation of the realistic corpus are
// matrix products and reductions left to torch.
//
// What bounds it on the H100: integer operations. A value costs one hash,
// ~75 32-bit integer operations (20 add-rotate-xor rounds and the key
// injections), against ~35 float operations for the normal and 4 bytes
// written; the SM has 64 INT32 lanes to its 128 FP32 ones, so the hashes
// set the pace (7.68e9 values of a 10M x 768 pass: ~34 ms at 1.98 GHz),
// and the 30.7 GB written take ~9 ms. Design: a block takes kRows rows; its
// first kRows threads derive each row's draws (9 hashes) into shared
// memory, then all threads walk the block's values in row-major order, so
// neighbouring threads write neighbouring words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows per block
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kNormalLo = -0.99999994f;  // nextafter(-1, 0)
constexpr float kSqrt2 = 1.41421354f;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int a, int b, int c,
                                       int d) {
  x0 += x1; x1 = rotl(x1, a) ^ x0;
  x0 += x1; x1 = rotl(x1, b) ^ x0;
  x0 += x1; x1 = rotl(x1, c) ^ x0;
  x0 += x1; x1 = rotl(x1, d) ^ x0;
}

// Threefry-2x32 of the counter (0, x1) under (k0, k1): JAX's unrolled
// lowering (jax/_src/prng.py _threefry2x32_lowering).
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = k0;
  x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// jax.random.bits of shape () or of position j of a vector.
__device__ __forceinline__ uint32_t bits(uint2 key, uint32_t j) {
  const uint2 y = threefry(key.x, key.y, j);
  return y.x ^ y.y;
}

__device__ __forceinline__ float erfinv_xla(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p;
  if (lt) {
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  return __fmul_rn(p, x);
}

// jax.random.normal from its 32 random bits.
__device__ __forceinline__ float normal(uint32_t b) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kNormalLo, __fadd_rn(__fmul_rn(f, 2.0f), kNormalLo));
  return __fmul_rn(erfinv_xla(u), kSqrt2);
}

__global__ void __launch_bounds__(kThreads) rowgen_kernel(
    const int32_t* __restrict__ ids, int n, int dim, const float* __restrict__ centers,
    int clusters, const float* __restrict__ spectrum, float sigma, uint32_t base0,
    uint32_t base1, float* __restrict__ out, int32_t* __restrict__ clusters_out) {
  __shared__ uint2 noise_key[kRows];
  __shared__ int cluster[kRows];
  __shared__ float radial[kRows];
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, n - row0);
  const bool realistic = spectrum != nullptr;
  if (threadIdx.x < rows) {
    const uint2 key = threefry(base0, base1, (uint32_t)ids[row0 + threadIdx.x]);
    const uint2 k_cluster = threefry(key.x, key.y, 0u);
    noise_key[threadIdx.x] = threefry(key.x, key.y, 1u);
    const uint32_t hi = bits(threefry(k_cluster.x, k_cluster.y, 0u), 0u);
    const uint32_t lo = bits(threefry(k_cluster.x, k_cluster.y, 1u), 0u);
    const uint32_t span = (uint32_t)max(clusters, 1);
    uint32_t mult = (65536u % span);
    mult = (mult * mult) % span;
    cluster[threadIdx.x] = (int)(((hi % span) * mult + lo % span) % span);
    if (clusters_out != nullptr) clusters_out[row0 + threadIdx.x] = cluster[threadIdx.x];
    radial[threadIdx.x] =
        realistic ? expf(__fmul_rn(0.25f, normal(bits(threefry(key.x, key.y, 2u), 0u))))
                  : 1.0f;
  }
  __syncthreads();
  const int total = rows * dim;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / dim;
    const int j = e - r * dim;
    const float noise = __fmul_rn(normal(bits(noise_key[r], (uint32_t)j)), sigma);
    const float c = centers[(long long)cluster[r] * dim + j];
    out[(row0 + r) * dim + j] =
        realistic ? __fmul_rn(__fadd_rn(c, __fmul_rn(noise, spectrum[j])), radial[r])
                  : __fadd_rn(c, noise);
  }
}

}  // namespace

// C interface, bound with ctypes (bench/threefry.py latent_rows): ids
// int32 [n] in [0, 2^31), centers f32 [clusters, dim], spectrum f32 [dim]
// or null (the clustered distribution), out f32 [n, dim], clusters_out
// int32 [n] (each row's cluster, for the checks) or null; all contiguous.

extern "C" {

int qtt_rowgen(const void* ids, int n, int dim, const void* centers, int clusters,
               const void* spectrum, float sigma, unsigned int base0, unsigned int base1,
               void* out, void* clusters_out, void* stream) {
  const int blocks = (n + kRows - 1) / kRows;
  rowgen_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n, dim, static_cast<const float*>(centers), clusters,
      static_cast<const float*>(spectrum), sigma, base0, base1, static_cast<float*>(out),
      static_cast<int32_t*>(clusters_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
