// Host-side fused AdamW over host-resident optimizer state.
//
// Reference capability: csrc/adam/cpu_adam.cpp (DeepSpeedCPUAdam's
// AVX256/AVX512 Step_1/4/8 kernels) — the compute half of ZeRO-Offload:
// fp32 master/m/v never cross the host<->device bus; only bf16 grads come
// down and bf16 params go back up (4 bytes/param/step instead of 28).
//
// Implementation: plain C++ written so g++ -O3 -march=native -fopenmp
// autovectorizes the hot loop (FMA over AVX2/AVX-512 lanes) — the modern
// equivalent of the reference's hand-rolled SIMD macros (simd.h), without
// maintaining per-ISA intrinsics. OpenMP splits the flat buffer across
// cores; each chunk is contiguous so the vectorizer sees unit stride.
//
// C ABI only (ctypes-friendly): no pybind11 in this image.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

inline float bf16_to_f32(uint16_t b) {
    uint32_t u = static_cast<uint32_t>(b) << 16;
    float f;
    std::memcpy(&f, &u, sizeof(f));
    return f;
}

inline uint16_t f32_to_bf16(float f) {
    uint32_t u;
    std::memcpy(&u, &f, sizeof(u));
    // round-to-nearest-even on the dropped 16 bits
    uint32_t rounding = 0x7FFF + ((u >> 16) & 1);
    u += rounding;
    return static_cast<uint16_t>(u >> 16);
}

}  // namespace

extern "C" {

// One fused AdamW step over a flat range. master/m/v: fp32 host buffers
// updated in place. grad_bf16: incoming gradient bits (bf16);
// param_bf16_out: updated params written back as bf16 bits (may be null if
// the caller only wants the state advanced). bias_c1/c2 = 1 - beta^t
// precomputed by the caller (0 < c <= 1); grad_scale multiplies grads
// (1/gas, clip coefficient, 1/loss_scale all folded in by the caller).
void dstpu_adam_step_bf16(float* master, float* m, float* v,
                          const uint16_t* grad_bf16,
                          uint16_t* param_bf16_out,
                          int64_t n, float lr, float beta1, float beta2,
                          float eps, float weight_decay, int adamw_mode,
                          float bias_c1, float bias_c2, float grad_scale) {
    const float one_m_b1 = 1.0f - beta1;
    const float one_m_b2 = 1.0f - beta2;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = bf16_to_f32(grad_bf16[i]) * grad_scale;
        float p = master[i];
        if (weight_decay != 0.0f && !adamw_mode) g += weight_decay * p;
        float mi = beta1 * m[i] + one_m_b1 * g;
        float vi = beta2 * v[i] + one_m_b2 * g * g;
        float upd = (mi / bias_c1) / (std::sqrt(vi / bias_c2) + eps);
        if (weight_decay != 0.0f && adamw_mode) upd += weight_decay * p;
        p -= lr * upd;
        master[i] = p;
        m[i] = mi;
        v[i] = vi;
        if (param_bf16_out) param_bf16_out[i] = f32_to_bf16(p);
    }
}

// fp32-gradient variant (CPU test harness / fp32 training).
void dstpu_adam_step_f32(float* master, float* m, float* v,
                         const float* grad, float* param_out,
                         int64_t n, float lr, float beta1, float beta2,
                         float eps, float weight_decay, int adamw_mode,
                         float bias_c1, float bias_c2, float grad_scale) {
    const float one_m_b1 = 1.0f - beta1;
    const float one_m_b2 = 1.0f - beta2;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grad[i] * grad_scale;
        float p = master[i];
        if (weight_decay != 0.0f && !adamw_mode) g += weight_decay * p;
        float mi = beta1 * m[i] + one_m_b1 * g;
        float vi = beta2 * v[i] + one_m_b2 * g * g;
        float upd = (mi / bias_c1) / (std::sqrt(vi / bias_c2) + eps);
        if (weight_decay != 0.0f && adamw_mode) upd += weight_decay * p;
        p -= lr * upd;
        master[i] = p;
        m[i] = mi;
        v[i] = vi;
        if (param_out) param_out[i] = p;
    }
}

// Squared L2 norm of a bf16 grad buffer (the global-norm pass runs host-
// side too, so clipping needs no extra device round trip).
double dstpu_sq_norm_bf16(const uint16_t* grad_bf16, int64_t n) {
    double acc = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : acc)
    for (int64_t i = 0; i < n; ++i) {
        double g = static_cast<double>(bf16_to_f32(grad_bf16[i]));
        acc += g * g;
    }
    return acc;
}

double dstpu_sq_norm_f32(const float* grad, int64_t n) {
    double acc = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : acc)
    for (int64_t i = 0; i < n; ++i) {
        double g = static_cast<double>(grad[i]);
        acc += g * g;
    }
    return acc;
}

}  // extern "C"
