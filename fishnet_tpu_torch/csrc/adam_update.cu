// K16 adam_update: one Adam step over flat f32 buffers, in place:
//   mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,
//   p  = p + (-lr) * ((mu / bc1) / (sqrt(nu / bc2) + eps)),
// with bc1 = 1 - b1^count and bc2 = 1 - b2^count computed by the host in
// f32 from the step count.
//
// Replaces: the optimizer's part of fishnet_tpu/models/train.py:47
// make_train_step, optimizer.update of optax.adam(lr) (optax
// scale_by_adam with eps_root 0, then scale(-lr)) and optax.apply_updates.
//
// Bound on the H100: bytes. It reads params, grads, mu and nu and writes
// params, mu and nu: 7 x 4 B a value, 1.97 MB for the shipped net's
// 70,344 values, ~0.6 us of HBM time; its ~12 flops a value are nothing
// against 67 TFLOP/s. Launch latency sets its time.
//
// Design: one grid-stride elementwise pass, a value a thread. Every
// operation is written as __fmul_rn, __fadd_rn, __fdiv_rn or __fsqrt_rn in
// optax's order, so the compiler contracts nothing into a fused
// multiply-add and each step rounds as the plain PyTorch version's does:
// the kernel equals it bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void adam_kernel(float* __restrict__ params, const float* __restrict__ grad,
                            float* __restrict__ mu, float* __restrict__ nu, int64_t n,
                            float neg_lr, float b1, float one_minus_b1, float b2,
                            float one_minus_b2, float eps, float bc1, float bc2) {
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * THREADS) {
        float g = grad[i];
        float m = __fadd_rn(__fmul_rn(g, one_minus_b1), __fmul_rn(mu[i], b1));
        float v = __fadd_rn(__fmul_rn(__fmul_rn(g, g), one_minus_b2), __fmul_rn(nu[i], b2));
        float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
        params[i] = __fadd_rn(params[i], __fmul_rn(u, neg_lr));
        mu[i] = m;
        nu[i] = v;
    }
}

}  // namespace

// params, grad, mu, nu: (n,) f32; params, mu, nu are updated in place
FISHNET_EXPORT int adam_update(void* params, const void* grad, void* mu, void* nu, int64_t n,
                               float neg_lr, float b1, float one_minus_b1, float b2,
                               float one_minus_b2, float eps, float bc1, float bc2,
                               void* stream) {
    int64_t blocks = (n + THREADS - 1) / THREADS;
    int grid = (int)(blocks < 4096 ? blocks : 4096);
    adam_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (float*)params, (const float*)grad, (float*)mu, (float*)nu, n, neg_lr, b1,
        one_minus_b1, b2, one_minus_b2, eps, bc1, bc2);
    return (int)cudaGetLastError();
}
