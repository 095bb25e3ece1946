// Host-side fused Adagrad over host-resident optimizer state.
//
// Reference capability: csrc/adagrad/cpu_adagrad.cpp (DeepSpeedCPUAdagrad's
// AVX Step_1/4/8 kernels) — the Adagrad member of the ZeRO-Offload host
// optimizer family: the fp32 master + accumulator never cross the
// host<->device bus; only compute-dtype grads come down and params go up.
//
// Same implementation strategy as csrc/adam/dstpu_cpu_adam.cpp: plain C++
// written so g++ -O3 -march=native -fopenmp autovectorizes the hot loop,
// C ABI only (ctypes; no pybind11 in this image).

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
    uint32_t rounding = 0x7FFF + ((u >> 16) & 1);  // round-to-nearest-even
    u += rounding;
    return static_cast<uint16_t>(u >> 16);
}

}  // namespace

extern "C" {

// One fused Adagrad step over a flat range: v += g^2;
// p -= lr * g / (sqrt(v) + eps), weight decay folded into g (the torch /
// reference cpu_adagrad convention). master/accum updated in place;
// param_bf16_out optional.
void dstpu_adagrad_step_bf16(float* master, float* accum,
                             const uint16_t* grad_bf16,
                             uint16_t* param_bf16_out,
                             int64_t n, float lr, float eps,
                             float weight_decay, float grad_scale) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = bf16_to_f32(grad_bf16[i]) * grad_scale;
        float p = master[i];
        if (weight_decay != 0.0f) g += weight_decay * p;
        float a = accum[i] + g * g;
        p -= lr * g / (std::sqrt(a) + eps);
        master[i] = p;
        accum[i] = a;
        if (param_bf16_out) param_bf16_out[i] = f32_to_bf16(p);
    }
}

void dstpu_adagrad_step_f32(float* master, float* accum, const float* grad,
                            float* param_out, int64_t n, float lr,
                            float eps, float weight_decay,
                            float grad_scale) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grad[i] * grad_scale;
        float p = master[i];
        if (weight_decay != 0.0f) g += weight_decay * p;
        float a = accum[i] + g * g;
        p -= lr * g / (std::sqrt(a) + eps);
        master[i] = p;
        accum[i] = a;
        if (param_out) param_out[i] = p;
    }
}

}  // extern "C"
