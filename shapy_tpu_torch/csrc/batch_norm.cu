// K4: train-mode BatchNorm, forward and backward, on channels-last
// activations in float32 or bfloat16.
//
// Replaces: shapy_tpu/models/backbones/layers.py:bn_train_core (lines
// 174-245, the jax.custom_vjp with the fused two-reduction backward) and
// the running-stat EMA of batch_norm (:270-281). It keeps the JAX
// package's numerics, not cuDNN's:
//   * moments in f32 as E[x^2] - E[x]^2 (:142-159);
//   * x_hat = (x - mean) * inv and y = x_hat * gamma + beta in the
//     activation dtype, each operation rounded to it, with mean, inv =
//     rsqrt(var + eps), gamma and beta first rounded to it (:162-165);
//   * running_mean += momentum-EMA of mean, running_var of the unbiased
//     var * n / (n - 1), in f32 (:270-281);
//   * dx = gamma inv (dy - mean(dy) - x_hat mean(dy x_hat)) in the
//     activation dtype, with f32 sums; dgamma = sum dy x_hat, dbeta =
//     sum dy (:198-242). x_hat is recomputed from x, never stored.
//
// What bounds it on the H100: device memory. Per element that is a few
// FLOP against 2-4 bytes; the largest layer of the flagship at batch 48
// holds ~50 M elements. At least, the forward reads x and writes y, the
// backward reads dy and x and writes dx. At the small layers (the 8^2 and
// 16^2 maps, many of a step's 326 BNs) the latency of dependent launches
// weighs more than the bytes.
//
// Design: an activation is an (R, C) row-major matrix, R = N H W rows. A
// thread owns V = 8 neighbouring channels of a row (one 16-byte load of
// bf16, two of f32; 1 channel where C % 8 != 0) and loads its channels'
// per-channel coefficients once, as 16-byte vectors, rounded once. Sums
// in a fixed order that depends on the shape alone, no float atomics: two
// calls give the same bits on any card. Both passes take one of two
// regimes, chosen by the wrapper from the shape alone (_bn_plan; the
// forward, with fewer registers, takes the cluster for more layers):
//   * the larger layers (the 128^2 to 32^2 maps; the backward's widest
//     8^2 ones): three launches over row tiles. A 256-thread block is
//     `lanes` row lanes x `group` channel chunks, group = min(C / 8, 256),
//     lanes = 256 / group: a warp covers whole rows (4 rows of a
//     64-channel layer);
//     blockIdx.y is the chunk group where C > 2048. (1) The partial sums of
//     each row tile: a thread's rows in order, then the row lanes in order.
//     (2) The finalize, a block per 8 channels: 32 lanes over strided
//     tiles, then the lanes in order. (3) The elementwise pass: dx a block
//     per row tile; y a grid that fills the card (the plan's bands), from
//     the last rows down (still in L2 from pass 1). x (and dy) are read
//     twice. The forward's (2) and (3) are programmatic dependent launches.
//   * small layers (few rows): one launch of a thread-block cluster of 8
//     or 16 blocks per chunk of 8 channels. Block b of the cluster takes
//     rows [b rows, (b + 1) rows), a thread every 256th of them; the block
//     sums its 256 lanes (8 groups of 32 in order, then the groups in
//     order), the cluster's barrier publishes the block sums in shared
//     memory, and every block adds them in block order through distributed
//     shared memory, derives the coefficients and writes y or dx of its
//     rows (its first four rows from registers, the rest from L2). No
//     grid-wide barrier, no partials in device memory.
// The forward's sums are x and x^2 (mean, var = E[x^2] - mean^2, inv =
// rsqrt(var + eps); block 0 of a cluster, or the finalize, writes mean,
// inv and the running stats); the backward's dy and dy x_hat.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Round to the activation dtype T (a no-op for float).
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x_hat in the activation dtype, as a float.
template <typename T>
__device__ __forceinline__ float xhat(float x, float mean_t, float inv_t) {
  return rnd<T>(rnd<T>(x - mean_t) * inv_t);
}

// ---- Shared by the forward and the backward --------------------------------
constexpr int kThreads = 256;

struct BnShape {
  int R, C, tiles, rows_per_tile, group, lanes;
};

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p,
                                        const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i],
                                                            v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// This thread's row lane and first channel; `active` where both exist.
struct Slot {
  int lane, c0;
  bool active;
};
template <int V>
__device__ __forceinline__ Slot slot(const BnShape& S) {
  Slot q;
  const int chunk = threadIdx.x % S.group;
  q.lane = threadIdx.x / S.group;
  q.c0 = (blockIdx.y * S.group + chunk) * V;
  q.active = q.lane < S.lanes && q.c0 < S.C;
  return q;
}

// V per-channel floats at p (16-byte aligned for V = 8), each rounded to
// the activation dtype.
template <typename T, int V>
__device__ __forceinline__ void load_rounded(const float* p, float (&v)[V]) {
  load_v<V>(p, v);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = rnd<T>(v[i]);
}

// Rows a thread keeps in flight: four, eight of one bf16 tensor (the
// forward's).
template <int K, typename T>
constexpr int kDepth = K == 1 && sizeof(T) == 2 ? 8 : 4;

// Calls row(v, r) with channels c0 .. c0 + V - 1 of rows r, r + step, ...
// < r1 of each of the K tensors in ts, in row order, kDepth<K, T> rows'
// loads in flight.
template <int V, int K, typename T, typename Row>
__device__ __forceinline__ void walk_rows(const T* const (&ts)[K], int C,
                                          int c0, int r, int r1, int step,
                                          Row row) {
  constexpr int D = kDepth<K, T>;
  for (; r + (D - 1) * step < r1; r += D * step) {
    float v[D][K][V];
#pragma unroll
    for (int j = 0; j < D; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        load_v<V>(ts[k] + (size_t)(r + j * step) * C + c0, v[j][k]);
      }
#pragma unroll
    for (int j = 0; j < D; ++j) row(v[j], r + j * step);
  }
  for (; r < r1; r += step) {
    float v[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) load_v<V>(ts[k] + (size_t)r * C + c0, v[k]);
    row(v, r);
  }
}

// A block's two sums a, b of V channels a thread, its row lanes added in
// lane order by lane 0, into partials (tiles, C, 2) of row tile `tile`.
template <int V>
__device__ __forceinline__ void lanes_to_partials(const float (&a)[V],
                                                  const float (&b)[V],
                                                  const Slot& q,
                                                  const BnShape& S, int tile,
                                                  float* __restrict__ part) {
  __shared__ float sh[2][kThreads * V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh[0][threadIdx.x * V + i] = a[i];
    sh[1][threadIdx.x * V + i] = b[i];
  }
  __syncthreads();
  if (!q.active || q.lane != 0) return;
  float s[V], t[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = t[i] = 0.f;
  for (int l = 0; l < S.lanes; ++l) {
    const int at = (l * S.group + threadIdx.x) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] += sh[0][at + i];
      t[i] += sh[1][at + i];
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float* p = part + ((size_t)tile * S.C + q.c0 + i) * 2;
    p[0] = s[i];
    p[1] = t[i];
  }
}

// The finalize's sums of channel c = 8 blockIdx.x + (threadIdx.x & 7): tile
// lane l (of 32) sums the partials of tiles l, l + 32, ... (eight loads in
// flight), then the lanes in order. Returns true in the thread (lane 0)
// that holds them in *s, *q.
constexpr int kTileLanes = 32;
__device__ __forceinline__ bool sum_tiles(const float* __restrict__ partials,
                                          int tiles, int C, float* s,
                                          float* q) {
  __shared__ float ss[kTileLanes][9], sq[kTileLanes][9];
  const int ch = threadIdx.x & 7, l = threadIdx.x >> 3;
  const int c = blockIdx.x * 8 + ch;
  float a = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 8
    for (int k = l; k < tiles; k += kTileLanes) {
      const float* p = partials + ((size_t)k * C + c) * 2;
      a += p[0];
      b += p[1];
    }
  }
  ss[l][ch] = a;
  sq[l][ch] = b;
  __syncthreads();
  if (l != 0 || c >= C) return false;
  a = 0.f;
  b = 0.f;
  for (int k = 0; k < kTileLanes; ++k) {
    a += ss[k][ch];
    b += sq[k][ch];
  }
  *s = a;
  *q = b;
  return true;
}

// The cluster regime. Thread-block cluster instructions: the barrier of
// the cluster's blocks (release / acquire), and a float of block `rank`'s
// shared memory at this block's address `local`.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float ld_cluster(const float* local,
                                            unsigned rank) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// A cluster block's two sums a, b (V channels a thread, lane l =
// threadIdx.x): lanes 32 g .. 32 g + 31 in order for g = 0 .. 7, those 8
// in order; then, after the cluster's barrier, the kCl blocks' sums in
// block order through distributed shared memory, into *s, *q of threads
// l < V (channel c0 + l). The caller arrives at the cluster's barrier
// again once it no longer needs the others' shared memory, and waits
// before it exits (its own block sums must live until then).
template <int V, int kCl>
__device__ __forceinline__ void cluster_sums(const float (&a)[V],
                                             const float (&b)[V], float* s,
                                             float* q) {
  __shared__ float ss[kThreads][V + 1], sq[kThreads][V + 1];
  __shared__ float gs[8][V], gq[8][V];
  __shared__ float block_sum[2][V];  // read by the cluster's blocks
  const int l = threadIdx.x;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ss[l][i] = a[i];
    sq[l][i] = b[i];
  }
  __syncthreads();
  if (l < 8 * V) {  // lanes 32 g .. 32 g + 31 in order, channel i
    const int i = l % V, g = l / V;
    float u = 0.f, w = 0.f;
    for (int k = 32 * g; k < 32 * g + 32; ++k) {
      u += ss[k][i];
      w += sq[k][i];
    }
    gs[g][i] = u;
    gq[g][i] = w;
  }
  __syncthreads();
  if (l < V) {  // the 8 groups in order
    float u = 0.f, w = 0.f;
    for (int g = 0; g < 8; ++g) {
      u += gs[g][l];
      w += gq[g][l];
    }
    block_sum[0][l] = u;
    block_sum[1][l] = w;
  }
  cluster_arrive();  // publishes block_sum to the cluster
  cluster_wait();
  if (l < V) {  // the cluster's blocks in order
    float u = 0.f, w = 0.f;
    for (int r = 0; r < kCl; ++r) {
      u += ld_cluster(&block_sum[0][l], r);
      w += ld_cluster(&block_sum[1][l], r);
    }
    *s = u;
    *q = w;
  }
}

// Programmatic dependent launch (Hopper): a kernel launched with
// launch_dependent may be scheduled once every block of the kernel before
// it has called griddep_trigger; it calls griddep_wait before it reads
// what that kernel wrote, which returns once that kernel has completed and
// its writes are visible. The split regime's finalize and elementwise
// passes so start while the pass before them drains.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
template <typename Kernel, typename... Args>
cudaError_t launch_dependent(Kernel kernel, dim3 grid, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// One launch of kKernel: a cluster of kCl blocks (along x) per chunk of
// channels, cgroups chunks (along y).
template <auto kKernel, int kCl, typename... Args>
cudaError_t launch_clusters(int cgroups, cudaStream_t stream,
                            Args... args) {
  if (kCl > 8) {  // above the portable cluster size: allowed once a device
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !allowed[dev]) {
      err = cudaFuncSetAttribute(
          kKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      if (dev < 64) allowed[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCl, cgroups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kKernel, args...);
}

// ---- Forward ----------------------------------------------------------------
//
// y = ((x - mean) * inv) * gamma + beta, each operation rounded to the
// activation dtype, mean, inv, gamma and beta rounded to it first (never
// one scale and shift: --fmad=false keeps each product rounded).

struct FwdArgs {
  const float* gamma;
  const float* beta;
  float* running_mean;  // or null, with running_var
  float* running_var;
  float* mean;
  float* inv;
  float eps, momentum, unbias;
};

// One row's V channels: s += x, q += x^2.
template <int V>
__device__ __forceinline__ void add_moments(const float (&xv)[V],
                                            float (&s)[V], float (&q)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] += xv[i];
    q[i] += xv[i] * xv[i];
  }
}

// A channel's mean, var = E[x^2] - mean^2 and inv = rsqrt(var + eps) from
// its sums over n rows, in f32.
struct Moments {
  float mean, var, inv;
};
__device__ __forceinline__ Moments moments(float s, float q, float n,
                                           float eps) {
  Moments m;
  m.mean = s / n;
  m.var = q / n - m.mean * m.mean;
  m.inv = rsqrtf(m.var + eps);
  return m;
}

// Channel c's mean and inv for the backward and, with the running stats,
// their EMA (the unbiased var).
__device__ __forceinline__ void write_moments(const FwdArgs& A, int c,
                                              const Moments& m) {
  A.mean[c] = m.mean;
  A.inv[c] = m.inv;
  if (A.running_mean != nullptr) {
    const float keep = 1.f - A.momentum;
    A.running_mean[c] = keep * A.running_mean[c] + A.momentum * m.mean;
    A.running_var[c] =
        keep * A.running_var[c] + A.momentum * (m.var * A.unbias);
  }
}

// One row's V channels of y; k[0..3] = mean, inv, gamma, beta, rounded.
template <typename T, int V>
__device__ __forceinline__ void y_row(const float (&xv)[V],
                                      const float (&k)[4][V], T* out) {
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    o[i] = rnd<T>(xhat<T>(xv[i], k[0][i], k[1][i]) * k[2][i]) + k[3][i];
  }
  store_v<V>(out, o);  // rounds the last sum
}

// Pass 1 of the split regime: row tile blockIdx.x's sums of x and x^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) fwd_partial_kernel(
    const T* __restrict__ x, float* __restrict__ partials, const BnShape S) {
  griddep_trigger();  // the finalize may be scheduled: it waits for us
  const int tile = blockIdx.x;
  const Slot q = slot<V>(S);
  float s[V], sq[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = sq[i] = 0.f;
  if (q.active) {
    const T* const ts[1] = {x};
    walk_rows<V>(ts, S.C, q.c0, tile * S.rows_per_tile + q.lane,
                 min(S.R, (tile + 1) * S.rows_per_tile), S.lanes,
                 [&](const float (&v)[1][V], int) {
                   add_moments<V>(v[0], s, sq);
                 });
  }
  lanes_to_partials<V>(s, sq, q, S, tile, partials);
}

// Pass 2: channels 8 blockIdx.x .. + 7, mean, inv and the running stats.
__global__ void __launch_bounds__(kThreads) fwd_finalize_kernel(
    const float* __restrict__ partials, int tiles, int C, float n,
    const FwdArgs A) {
  griddep_wait();  // the partials are complete
  griddep_trigger();
  float s, q;
  if (sum_tiles(partials, tiles, C, &s, &q)) {
    write_moments(A, blockIdx.x * 8 + (threadIdx.x & 7),
                  moments(s, q, n, A.eps));
  }
}

// The rounded coefficients of channels c0 .. c0 + V - 1.
template <typename T, int V>
__device__ __forceinline__ void load_coefs(const float* mean,
                                           const float* inv,
                                           const float* gamma,
                                           const float* beta, int c0,
                                           float (&k)[4][V]) {
  load_rounded<T, V>(mean + c0, k[0]);
  load_rounded<T, V>(inv + c0, k[1]);
  load_rounded<T, V>(gamma + c0, k[2]);
  load_rounded<T, V>(beta + c0, k[3]);
}

// Pass 3: y, a thread every gridDim.x lanes-th row from the last band of
// gridDim.x lanes rows down (pass 1 read those last: where the layer is
// larger than L2 they are still there). No sum: the rows' partition, and
// with it the grid (the plan's `bands`, sized for kNormPerSm blocks an
// SM), changes no bit of y.
constexpr int kNormPerSm = 4;  // layers.py's _BN_NORM_BLOCKS assumes it
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kNormPerSm) fwd_normalize_kernel(
    const T* __restrict__ x, const FwdArgs A, T* __restrict__ y,
    const BnShape S) {
  griddep_wait();  // mean and inv are written
  const Slot q = slot<V>(S);
  const int first = blockIdx.x * S.lanes + q.lane;
  if (!q.active || first >= S.R) return;
  float k[4][V];
  load_coefs<T, V>(A.mean, A.inv, A.gamma, A.beta, q.c0, k);
  const int band = gridDim.x * S.lanes;
  auto at = [&](int b) { return (size_t)(first + b * band) * S.C + q.c0; };
  constexpr int D = kDepth<1, T>;
  int b = (S.R - 1 - first) / band;  // this thread's last band
  for (; b >= D - 1; b -= D) {
    float v[D][V];
#pragma unroll
    for (int j = 0; j < D; ++j) load_v<V>(x + at(b - j), v[j]);
#pragma unroll
    for (int j = 0; j < D; ++j) y_row<T, V>(v[j], k, y + at(b - j));
  }
  for (; b >= 0; --b) {
    float v[V];
    load_v<V>(x + at(b), v);
    y_row<T, V>(v, k, y + at(b));
  }
}

// The cluster regime: cluster blockIdx.y (channels c0 = V y .. c0 + V -
// 1) of kCl blocks, block blockIdx.x of it: rows [x rows_per_tile, ...), a
// thread every 256th. A thread's first four rows stay in registers from
// the sums to y.
template <typename T, int V, int kCl>
__global__ void __launch_bounds__(kThreads) fwd_cluster_kernel(
    const T* __restrict__ x, const FwdArgs A, T* __restrict__ y,
    const BnShape S) {
  __shared__ float coefs[4][V];  // mean, inv, gamma, beta, rounded
  const int l = threadIdx.x, rank = blockIdx.x;
  const int c0 = blockIdx.y * V;
  const int r0 = rank * S.rows_per_tile + l;
  const int r1 = min(S.R, rank * S.rows_per_tile + S.rows_per_tile);
  auto at = [&](int r) { return (size_t)r * S.C + c0; };
  float s[V], sq[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = sq[i] = 0.f;
  float x0[4][V];  // rows r0, r0 + 256, r0 + 512, r0 + 768
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) load_v<V>(x + at(r0 + j * kThreads), x0[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) add_moments<V>(x0[j], s, sq);
  }
  const T* const ts[1] = {x};
  walk_rows<V>(ts, S.C, c0, r0 + 4 * kThreads, r1, kThreads,
               [&](const float (&v)[1][V], int) {
                 add_moments<V>(v[0], s, sq);
               });
  float sum, sum2;
  cluster_sums<V, kCl>(s, sq, &sum, &sum2);
  if (l < V) {
    const int c = c0 + l;
    const Moments m = moments(sum, sum2, (float)S.R, A.eps);
    if (rank == 0) write_moments(A, c, m);
    coefs[0][l] = rnd<T>(m.mean);
    coefs[1][l] = rnd<T>(m.inv);
    coefs[2][l] = rnd<T>(A.gamma[c]);
    coefs[3][l] = rnd<T>(A.beta[c]);
  }
  // The remote reads are done once every block arrives again; each block
  // waits for that only before it exits (its block sums must live on).
  cluster_arrive();
  __syncthreads();
  float k[4][V];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) k[j][i] = coefs[j][i];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) {
      y_row<T, V>(x0[j], k, y + at(r0 + j * kThreads));
    }
  }
  walk_rows<V>(ts, S.C, c0, r0 + 4 * kThreads, r1, kThreads,
               [&](const float (&v)[1][V], int r) {
                 y_row<T, V>(v[0], k, y + at(r));
               });
  cluster_wait();
}

template <typename T, int V>
cudaError_t forward(const void* x, const FwdArgs& A, void* partials, void* y,
                    const BnShape& S, int fused, int bands,
                    cudaStream_t stream) {
  const T* x_t = (const T*)x;
  T* y_t = (T*)y;
  if (fused) {
    if (S.tiles == 16) {
      return launch_clusters<fwd_cluster_kernel<T, V, 16>, 16>(
          S.C / V, stream, x_t, A, y_t, S);
    }
    return launch_clusters<fwd_cluster_kernel<T, V, 8>, 8>(
        S.C / V, stream, x_t, A, y_t, S);
  }
  const int cgroups = (S.C / V + S.group - 1) / S.group;
  fwd_partial_kernel<T, V><<<dim3(S.tiles, cgroups), kThreads, 0, stream>>>(
      x_t, (float*)partials, S);
  cudaError_t launched = launch_dependent(
      fwd_finalize_kernel, dim3((S.C + 7) / 8), stream,
      (const float*)partials, S.tiles, S.C, (float)S.R, A);
  if (launched == cudaSuccess) {
    launched = launch_dependent(fwd_normalize_kernel<T, V>,
                                dim3(bands, cgroups), stream, x_t, A, y_t, S);
  }
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// ---- Backward -------------------------------------------------------------
//
// dx = gamma inv (dy - mean(dy) - x_hat mean(dy x_hat)), dgamma = sum dy
// x_hat, dbeta = sum dy: two f32 sums a channel over the R rows, then an
// elementwise pass, in the regimes above.

// One row's V channels: s += dy, sx += dy x_hat.
template <typename T, int V>
__device__ __forceinline__ void add_row(const float (&d)[V],
                                        const float (&xv)[V],
                                        const float (&m)[V],
                                        const float (&iv)[V], float (&s)[V],
                                        float (&sx)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] += d[i];
    sx[i] += d[i] * xhat<T>(xv[i], m[i], iv[i]);
  }
}

// One row's V channels of dx = (gamma inv) ((dy - mean(dy)) - x_hat
// mean(dy x_hat)), each operation rounded to the activation dtype; k0, k1,
// k2 are mean(dy), mean(dy x_hat) and gamma inv, rounded.
template <typename T, int V>
__device__ __forceinline__ void dx_row(const float (&d)[V],
                                       const float (&xv)[V],
                                       const float (&m)[V],
                                       const float (&iv)[V],
                                       const float (&k0)[V],
                                       const float (&k1)[V],
                                       const float (&k2)[V], T* out) {
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float h = xhat<T>(xv[i], m[i], iv[i]);
    const float a = rnd<T>(d[i] - k0[i]);
    const float b = rnd<T>(h * k1[i]);
    o[i] = k2[i] * rnd<T>(a - b);
  }
  store_v<V>(out, o);
}

// Row tile blockIdx.x's partial sums of dy and dy x_hat for this block's
// channels, into partials (tiles, C, 2).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bwd_partial_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ inv,
    float* __restrict__ partials, const BnShape S) {
  const int tile = blockIdx.x;
  const Slot q = slot<V>(S);
  float s[V], sx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = sx[i] = 0.f;
  if (q.active) {
    float m[V], iv[V];
    load_rounded<T, V>(mean + q.c0, m);
    load_rounded<T, V>(inv + q.c0, iv);
    const T* const ts[2] = {dy, x};
    walk_rows<V>(ts, S.C, q.c0, tile * S.rows_per_tile + q.lane,
                 min(S.R, (tile + 1) * S.rows_per_tile), S.lanes,
                 [&](const float (&v)[2][V], int) {
                   add_row<T, V>(v[0], v[1], m, iv, s, sx);
                 });
  }
  lanes_to_partials<V>(s, sx, q, S, tile, partials);
}

// The finalize of channels 8 b .. 8 b + 7 (block b): writes dgamma, dbeta
// and the dx coefficients coef (3, C) = [mean(dy), mean(dy x_hat), gamma *
// inv].
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_finalize_kernel(
    const float* __restrict__ partials, int tiles, int C, float n,
    const float* __restrict__ gamma, const float* __restrict__ inv,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    float* __restrict__ coef) {
  float s, q;
  if (!sum_tiles(partials, tiles, C, &s, &q)) return;
  const int c = blockIdx.x * 8 + (threadIdx.x & 7);
  dgamma[c] = q;
  dbeta[c] = s;
  coef[c] = s / n;
  coef[C + c] = q / n;
  coef[2 * C + c] = gamma[c] * rnd<T>(inv[c]);
}

// dx of row tile blockIdx.x for this block's channels, from the
// coefficients coef (3, C).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bwd_dx_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ inv,
    const float* __restrict__ coef, T* __restrict__ dx, const BnShape S) {
  const int r0 = blockIdx.x * S.rows_per_tile;
  const int r1 = min(S.R, r0 + S.rows_per_tile);
  const Slot q = slot<V>(S);
  if (!q.active) return;
  float m[V], iv[V], k0[V], k1[V], k2[V];
  load_rounded<T, V>(mean + q.c0, m);
  load_rounded<T, V>(inv + q.c0, iv);
  load_rounded<T, V>(coef + q.c0, k0);
  load_rounded<T, V>(coef + S.C + q.c0, k1);
  load_rounded<T, V>(coef + 2 * S.C + q.c0, k2);
  const T* const ts[2] = {dy, x};
  walk_rows<V>(ts, S.C, q.c0, r0 + q.lane, r1, S.lanes,
               [&](const float (&v)[2][V], int r) {
                 dx_row<T, V>(v[0], v[1], m, iv, k0, k1, k2,
                              dx + (size_t)r * S.C + q.c0);
               });
}

// The cluster regime's backward (see the forward's: the same rows, sums and
// barriers).
template <typename T, int V, int kCl>
__global__ void __launch_bounds__(kThreads) bwd_cluster_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mean,
    const float* __restrict__ inv, float* __restrict__ dgamma,
    float* __restrict__ dbeta, T* __restrict__ dx, const BnShape S) {
  __shared__ float coefs[3][V];  // the dx coefficients, rounded
  const int l = threadIdx.x, rank = blockIdx.x;
  const int c0 = blockIdx.y * V;
  const int r0 = rank * S.rows_per_tile + l;
  const int r1 = min(S.R, rank * S.rows_per_tile + S.rows_per_tile);
  float m[V], iv[V];
  load_rounded<T, V>(mean + c0, m);
  load_rounded<T, V>(inv + c0, iv);
  float s[V], sx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = sx[i] = 0.f;
  auto at = [&](int r) { return (size_t)r * S.C + c0; };
  float d0[4][V], x0[4][V];  // rows r0, r0 + 256, r0 + 512, r0 + 768
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) {
      load_v<V>(dy + at(r0 + j * kThreads), d0[j]);
      load_v<V>(x + at(r0 + j * kThreads), x0[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) add_row<T, V>(d0[j], x0[j], m, iv, s, sx);
  }
  const T* const ts[2] = {dy, x};
  walk_rows<V>(ts, S.C, c0, r0 + 4 * kThreads, r1, kThreads,
               [&](const float (&v)[2][V], int) {
                 add_row<T, V>(v[0], v[1], m, iv, s, sx);
               });
  float sdy, sdyx;
  cluster_sums<V, kCl>(s, sx, &sdy, &sdyx);
  if (l < V) {
    const int c = c0 + l;
    const float n = (float)S.R;
    if (rank == 0) {
      dgamma[c] = sdyx;
      dbeta[c] = sdy;
    }
    coefs[0][l] = rnd<T>(sdy / n);
    coefs[1][l] = rnd<T>(sdyx / n);
    coefs[2][l] = rnd<T>(gamma[c] * rnd<T>(inv[c]));
  }
  cluster_arrive();  // as in the forward
  __syncthreads();
  float k0[V], k1[V], k2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    k0[i] = coefs[0][i];
    k1[i] = coefs[1][i];
    k2[i] = coefs[2][i];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) {
      dx_row<T, V>(d0[j], x0[j], m, iv, k0, k1, k2,
                   dx + at(r0 + j * kThreads));
    }
  }
  walk_rows<V>(ts, S.C, c0, r0 + 4 * kThreads, r1, kThreads,
               [&](const float (&v)[2][V], int r) {
                 dx_row<T, V>(v[0], v[1], m, iv, k0, k1, k2, dx + at(r));
               });
  cluster_wait();
}

template <typename T, int V>
cudaError_t backward(const void* dy, const void* x, const void* gamma,
                     const void* mean, const void* inv, void* partials,
                     void* coef, void* dgamma, void* dbeta, void* dx,
                     const BnShape& S, int fused, cudaStream_t stream) {
  const T* dy_t = (const T*)dy;
  const T* x_t = (const T*)x;
  const float* gamma_f = (const float*)gamma;
  const float* mean_f = (const float*)mean;
  const float* inv_f = (const float*)inv;
  if (fused) {
    if (S.tiles == 16) {
      return launch_clusters<bwd_cluster_kernel<T, V, 16>, 16>(
          S.C / V, stream, dy_t, x_t, gamma_f, mean_f, inv_f, (float*)dgamma,
          (float*)dbeta, (T*)dx, S);
    }
    return launch_clusters<bwd_cluster_kernel<T, V, 8>, 8>(
        S.C / V, stream, dy_t, x_t, gamma_f, mean_f, inv_f, (float*)dgamma,
        (float*)dbeta, (T*)dx, S);
  }
  const int cgroups = (S.C / V + S.group - 1) / S.group;
  bwd_partial_kernel<T, V><<<dim3(S.tiles, cgroups), kThreads, 0, stream>>>(
      dy_t, x_t, mean_f, inv_f, (float*)partials, S);
  bwd_finalize_kernel<T><<<(S.C + 7) / 8, kThreads, 0, stream>>>(
      (const float*)partials, S.tiles, S.C, (float)S.R, gamma_f, inv_f,
      (float*)dgamma, (float*)dbeta, (float*)coef);
  bwd_dx_kernel<T, V><<<dim3(S.tiles, cgroups), kThreads, 0, stream>>>(
      dy_t, x_t, mean_f, inv_f, (const float*)coef, (T*)dx, S);
  return cudaGetLastError();
}

// The shape of a launch from the plan's arguments, or false for what the
// kernels do not take.
bool bn_shape(int R, int C, int tiles, int rows_per_tile, int vec, int fused,
              BnShape* S) {
  if ((vec != 8 && vec != 1) || C % vec != 0 || tiles < 1 ||
      rows_per_tile < 1 || (long long)tiles * rows_per_tile < R ||
      (fused && ((tiles != 8 && tiles != 16) || C / vec > 65535))) {
    return false;
  }
  S->R = R;
  S->C = C;
  S->tiles = tiles;
  S->rows_per_tile = rows_per_tile;
  S->group = C / vec < kThreads ? C / vec : kThreads;
  S->lanes = kThreads / S->group;
  return true;
}

}  // namespace

// The plan's arguments (both passes): rows [k rows_per_tile, ...) form
// tile k; vec: channels a thread takes, 8 (C % 8 == 0; the activations and
// the per-channel vectors 16-byte aligned) or 1; fused 0: partials (tiles,
// C, 2) f32 scratch (the backward's coef (3, C) too), fused 1: one cluster
// of `tiles` blocks (8 or 16) per vec channels, no scratch; bands (the
// forward's, fused 0): the elementwise pass's blocks along the rows. Each
// returns the launches' error, cudaErrorInvalidValue for arguments it does
// not take.

// x, y (R, C) channels-last activations, bf16 when is_bf16 else f32;
// gamma, beta (C,) f32; running_mean / running_var (C,) f32, updated in
// place, or both null; mean, inv (C,) f32 outputs saved for the backward.
extern "C" int bn_forward(const void* x, const void* gamma, const void* beta,
                          void* running_mean, void* running_var,
                          void* partials, void* mean, void* inv, void* y,
                          int R, int C, int tiles, int rows_per_tile,
                          int bands, int vec, int fused, int is_bf16,
                          float eps, float momentum, float unbias,
                          void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  BnShape S;
  if (!bn_shape(R, C, tiles, rows_per_tile, vec, fused, &S) ||
      (!fused && bands < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  FwdArgs A;
  A.gamma = (const float*)gamma;
  A.beta = (const float*)beta;
  A.running_mean = (float*)running_mean;
  A.running_var = (float*)running_var;
  A.mean = (float*)mean;
  A.inv = (float*)inv;
  A.eps = eps;
  A.momentum = momentum;
  A.unbias = unbias;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return vec == 8 ? (int)forward<__nv_bfloat16, 8>(x, A, partials, y, S,
                                                     fused, bands, s)
                    : (int)forward<__nv_bfloat16, 1>(x, A, partials, y, S,
                                                     fused, bands, s);
  }
  return vec == 8
             ? (int)forward<float, 8>(x, A, partials, y, S, fused, bands, s)
             : (int)forward<float, 1>(x, A, partials, y, S, fused, bands, s);
}

// dy, x, dx (R, C) in the activation dtype; gamma, mean, inv (C,) f32;
// dgamma, dbeta (C,) f32 outputs.
extern "C" int bn_backward(const void* dy, const void* x, const void* gamma,
                           const void* mean, const void* inv, void* partials,
                           void* coef, void* dgamma, void* dbeta, void* dx,
                           int R, int C, int tiles, int rows_per_tile,
                           int vec, int fused, int is_bf16, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  BnShape S;
  if (!bn_shape(R, C, tiles, rows_per_tile, vec, fused, &S)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return vec == 8
               ? (int)backward<__nv_bfloat16, 8>(dy, x, gamma, mean, inv,
                                                 partials, coef, dgamma,
                                                 dbeta, dx, S, fused, s)
               : (int)backward<__nv_bfloat16, 1>(dy, x, gamma, mean, inv,
                                                 partials, coef, dgamma,
                                                 dbeta, dx, S, fused, s);
  }
  return vec == 8 ? (int)backward<float, 8>(dy, x, gamma, mean, inv,
                                            partials, coef, dgamma, dbeta,
                                            dx, S, fused, s)
                  : (int)backward<float, 1>(dy, x, gamma, mean, inv,
                                            partials, coef, dgamma, dbeta,
                                            dx, S, fused, s);
}
