// K3: the residual recursion of paper eq. 10,
//     out = (1 - lam) r + lam (y - dt z),
// f32 compute, output in r's type, lam and dt read from device memory
// (replaces the Pallas kernel at
// src/repro/kernels/residual_update/residual_update.py:45). The _rn
// intrinsics keep nvcc from contracting into FMAs, so the kernel rounds
// exactly as the plain PyTorch version's separate ops do.
#include "common.cuh"

template <typename T>
__global__ void residual_update_kernel(const T* __restrict__ r, const T* __restrict__ y,
                                       const T* __restrict__ z, const float* __restrict__ lam_p,
                                       const float* __restrict__ dt_p, T* out, int m) {
  const float lam = *lam_p, dt = *dt_p;
  const float one_m = __fsub_rn(1.0f, lam);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += gridDim.x * blockDim.x) {
    const float a = __fmul_rn(one_m, to_f32(r[i]));
    const float b = __fmul_rn(lam, __fsub_rn(to_f32(y[i]), __fmul_rn(dt, to_f32(z[i]))));
    out[i] = from_f32<T>(__fadd_rn(a, b));
  }
}

extern "C" int residual_update_launch(const void* r, const void* y, const void* z,
                                      const float* lam, const float* dt, void* out, int m,
                                      int dtype, void* stream) {
  const int threads = 256;
  int blocks = (m + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    residual_update_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(y),
        static_cast<const float*>(z), lam, dt, static_cast<float*>(out), m);
  } else if (dtype == DT_BF16) {
    residual_update_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(z), lam, dt, static_cast<__nv_bfloat16*>(out), m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
