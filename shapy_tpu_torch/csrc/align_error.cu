// K8b aligned point error, forward only.
//
// Replaces: shapy_tpu/eval/metrics.py `PointError.__call__` (:181), i.e. an
// alignment of the estimate onto the ground truth -- `no_alignment` (:87),
// `root_align` (:91), `translation_align` (:101), `scale_align` (:109) or
// `procrustes_align` (:123, batched SVD with the sign(det(U V^T))
// reflection fix) -- followed by `point_error` (:31). The JAX package left
// this to XLA on the TPU (jnp.linalg.svd of (B, 3, 3) plus elementwise
// passes over (B, P, 3)).
//
// What bounds it on the H100: memory. Per body it reads est and gt once
// (24 B a point) and writes 4 B a point; the arithmetic is ~40 FLOP a
// point plus one 3x3 SVD per body. At the evaluator's shapes (B = 32,
// P = 10475 vertices) that is 9.4 MB, ~2.8 us at 3.35 TB/s.
//
// Design: one block per body, 256 threads, three fixed-order sweeps over
// the body's points (means; centred second moments; errors). Both point
// sets of a body (251 KB at P = 10475) do not fit in shared memory, so
// the second and third sweeps read them again, from L2 (the whole batch
// is 8 MB of the 50 MB L2). Sums are taken in double, per thread in point
// order, then by a fixed warp-shuffle tree and a fixed walk over the
// warps: no atomics, so every run gives the same bits. One thread per
// body then solves the 3x3 Procrustes problem in double in registers:
// Jacobi rotations diagonalise K^T K = V S^2 V^T, u_i = K v_i / |K v_i|
// for the two largest singular values, and the third axes are the cross
// products v1 x v2 and u1 x u2. R = sum_i v_i u_i^T is then exactly the
// proper rotation V diag(1, 1, sign det(U V^T)) U^T of the JAX code (no
// sign ambiguity: each pair (u_i, v_i) flips together). The aligned
// point and its error are formed in float, in the plain version's order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Mode { kNone = 0, kRoot = 1, kTranslation = 2, kScale = 3,
            kProcrustes = 4 };

// Sums v[i] over the block in a fixed order; the result is valid in
// thread 0. `red` holds N * kWarps doubles of shared memory.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    v[i] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * kWarps + warp] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += red[i * kWarps + w];
      v[i] = s;
    }
  }
  __syncthreads();  // `red` may be reused after this
}

__device__ __forceinline__ void cross(const double* a, const double* b,
                                      double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void normalize(double* a) {
  const double n = sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  const double inv = n > 0.0 ? 1.0 / n : 0.0;
  a[0] *= inv;
  a[1] *= inv;
  a[2] *= inv;
}

// Any unit vector orthogonal to the unit vector a.
__device__ void orthogonal(const double* a, double* out) {
  const double e[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  int k = 0;
  if (fabs(a[1]) < fabs(a[k])) k = 1;
  if (fabs(a[2]) < fabs(a[k])) k = 2;
  cross(a, e[k], out);
  normalize(out);
}

// The rotation R (row-major) of the Procrustes alignment of x1 onto x2
// from K = sum_p x1_p x2_p^T (row-major): R = V Z U^T with K = U S V^T.
__device__ void procrustes_rotation(const double* K, double* R) {
  // A = K^T K, symmetric; Jacobi rotations A <- J^T A J, V <- V J.
  double a[3][3], v[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      a[i][j] = K[0 * 3 + i] * K[0 * 3 + j] + K[1 * 3 + i] * K[1 * 3 + j] +
                K[2 * 3 + i] * K[2 * 3 + j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  const int P_[3] = {0, 0, 1};
  const int Q_[3] = {1, 2, 2};
  for (int sweep = 0; sweep < 32; ++sweep) {
    const double off = a[0][1] * a[0][1] + a[0][2] * a[0][2] +
                       a[1][2] * a[1][2];
    const double diag = a[0][0] * a[0][0] + a[1][1] * a[1][1] +
                        a[2][2] * a[2][2];
    if (!(off > 1e-30 * diag)) break;
    for (int r = 0; r < 3; ++r) {
      const int p = P_[r], q = Q_[r];
      if (a[p][q] == 0.0) continue;
      const double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
      const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                       (fabs(theta) + sqrt(theta * theta + 1.0));
      const double c = 1.0 / sqrt(t * t + 1.0);
      const double s = t * c;
      for (int k = 0; k < 3; ++k) {
        const double akp = a[k][p], akq = a[k][q];
        a[k][p] = c * akp - s * akq;
        a[k][q] = s * akp + c * akq;
      }
      for (int k = 0; k < 3; ++k) {
        const double apk = a[p][k], aqk = a[q][k];
        a[p][k] = c * apk - s * aqk;
        a[q][k] = s * apk + c * aqk;
      }
      for (int k = 0; k < 3; ++k) {
        const double vkp = v[k][p], vkq = v[k][q];
        v[k][p] = c * vkp - s * vkq;
        v[k][q] = s * vkp + c * vkq;
      }
    }
  }
  // The two largest eigenvalues of K^T K (squared singular values).
  int i1 = 0;
  if (a[1][1] > a[i1][i1]) i1 = 1;
  if (a[2][2] > a[i1][i1]) i1 = 2;
  int i2 = i1 == 0 ? 1 : 0;
  for (int k = 0; k < 3; ++k) {
    if (k != i1 && a[k][k] > a[i2][i2]) i2 = k;
  }
  double v1[3] = {v[0][i1], v[1][i1], v[2][i1]};
  double v2[3] = {v[0][i2], v[1][i2], v[2][i2]};
  double u1[3], u2[3], u3[3], v3[3];
  for (int i = 0; i < 3; ++i) {
    u1[i] = K[i * 3 + 0] * v1[0] + K[i * 3 + 1] * v1[1] + K[i * 3 + 2] * v1[2];
    u2[i] = K[i * 3 + 0] * v2[0] + K[i * 3 + 1] * v2[1] + K[i * 3 + 2] * v2[2];
  }
  normalize(u1);
  if (u1[0] == 0.0 && u1[1] == 0.0 && u1[2] == 0.0) u1[0] = 1.0;  // K = 0
  // Gram-Schmidt keeps U orthonormal when sigma_2 is tiny.
  const double d = u1[0] * u2[0] + u1[1] * u2[1] + u1[2] * u2[2];
  for (int i = 0; i < 3; ++i) u2[i] -= d * u1[i];
  const double n2 = sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
  if (n2 > 1e-300) {
    for (int i = 0; i < 3; ++i) u2[i] /= n2;
  } else {
    orthogonal(u1, u2);  // rank <= 1: any completion is a solution
  }
  cross(v1, v2, v3);
  cross(u1, u2, u3);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      R[i * 3 + j] = v1[i] * u1[j] + v2[i] * u2[j] + v3[i] * u3[j];
    }
  }
}

__global__ void align_error_kernel(const float* __restrict__ est,
                                   const float* __restrict__ gt,
                                   const int* __restrict__ root, int n_root,
                                   float* __restrict__ out, int P, int mode) {
  __shared__ double red[10 * kWarps];
  // Broadcast to every thread: mu1 (3), mu2 (3), scale, R (9).
  __shared__ float params[16];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* e = est + (size_t)b * P * 3;
  const float* g = gt + (size_t)b * P * 3;
  float* o = out + (size_t)b * P;

  if (tid == 0) {
    for (int i = 0; i < 16; ++i) params[i] = 0.f;
    params[6] = 1.f;
    params[7] = params[11] = params[15] = 1.f;  // R = I
  }
  if (mode == kRoot) {
    if (tid == 0) {
      double s[6] = {0, 0, 0, 0, 0, 0};
      for (int r = 0; r < n_root; ++r) {
        const int p = root[r];
        for (int k = 0; k < 3; ++k) {
          s[k] += e[p * 3 + k];
          s[3 + k] += g[p * 3 + k];
        }
      }
      for (int k = 0; k < 6; ++k) params[k] = (float)(s[k] / n_root);
    }
  } else if (mode >= kTranslation) {
    double s[6] = {0, 0, 0, 0, 0, 0};
    for (int p = tid; p < P; p += kThreads) {
      for (int k = 0; k < 3; ++k) {
        s[k] += e[p * 3 + k];
        s[3 + k] += g[p * 3 + k];
      }
    }
    block_sum<6>(s, red);
    if (tid == 0) {
      for (int k = 0; k < 6; ++k) params[k] = (float)(s[k] / P);
    }
  }
  __syncthreads();

  if (mode >= kScale) {
    const float m1x = params[0], m1y = params[1], m1z = params[2];
    const float m2x = params[3], m2y = params[4], m2z = params[5];
    // var1, then var2 (scale) or K row-major (procrustes).
    double s[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int p = tid; p < P; p += kThreads) {
      const float x1[3] = {e[p * 3] - m1x, e[p * 3 + 1] - m1y,
                           e[p * 3 + 2] - m1z};
      const float x2[3] = {g[p * 3] - m2x, g[p * 3 + 1] - m2y,
                           g[p * 3 + 2] - m2z};
      s[0] += (double)x1[0] * x1[0] + (double)x1[1] * x1[1] +
              (double)x1[2] * x1[2];
      if (mode == kScale) {
        s[1] += (double)x2[0] * x2[0] + (double)x2[1] * x2[1] +
                (double)x2[2] * x2[2];
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            s[1 + i * 3 + j] += (double)x1[i] * x2[j];
          }
        }
      }
    }
    block_sum<10>(s, red);
    if (tid == 0) {
      const double var1 = fmax(s[0], 1e-12);
      if (mode == kScale) {
        params[6] = (float)sqrt(s[1] / var1);
      } else {
        double R[9];
        procrustes_rotation(s + 1, R);
        double trace = 0.0;  // trace(R K)
        for (int i = 0; i < 3; ++i) {
          for (int j = 0; j < 3; ++j) trace += R[i * 3 + j] * s[1 + j * 3 + i];
        }
        params[6] = (float)(trace / var1);
        for (int i = 0; i < 9; ++i) params[7 + i] = (float)R[i];
      }
    }
    __syncthreads();
  }

  const float m1x = params[0], m1y = params[1], m1z = params[2];
  const float m2x = params[3], m2y = params[4], m2z = params[5];
  const float scale = params[6];
  float R[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = params[7 + i];
  for (int p = tid; p < P; p += kThreads) {
    const float ex = e[p * 3], ey = e[p * 3 + 1], ez = e[p * 3 + 2];
    const float gx = g[p * 3], gy = g[p * 3 + 1], gz = g[p * 3 + 2];
    float dx, dy, dz;
    if (mode == kNone) {
      dx = ex - gx;
      dy = ey - gy;
      dz = ez - gz;
    } else if (mode == kRoot || mode == kTranslation) {
      dx = (ex - m1x) - (gx - m2x);
      dy = (ey - m1y) - (gy - m2y);
      dz = (ez - m1z) - (gz - m2z);
    } else if (mode == kScale) {
      dx = (scale * (ex - m1x) + m2x) - gx;
      dy = (scale * (ey - m1y) + m2y) - gy;
      dz = (scale * (ez - m1z) + m2z) - gz;
    } else {
      const float x = ex - m1x, y = ey - m1y, z = ez - m1z;
      dx = (scale * (R[0] * x + R[1] * y + R[2] * z) + m2x) - gx;
      dy = (scale * (R[3] * x + R[4] * y + R[5] * z) + m2y) - gy;
      dz = (scale * (R[6] * x + R[7] * y + R[8] * z) + m2z) - gz;
    }
    o[p] = sqrtf(dx * dx + dy * dy + dz * dz);
  }
}

}  // namespace

// est, gt (B, P, 3) f32; root (n_root,) int32 indices into P (read only in
// root mode); out (B, P) f32. All contiguous on the device. mode: 0 none,
// 1 root, 2 translation, 3 scale, 4 procrustes. Returns cudaGetLastError().
extern "C" int align_error_forward(const void* est, const void* gt,
                                   const void* root, void* out, int B, int P,
                                   int n_root, int mode, void* stream) {
  align_error_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)est, (const float*)gt, (const int*)root, n_root,
      (float*)out, P, mode);
  return (int)cudaGetLastError();
}
