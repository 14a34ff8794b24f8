// tdaudio: the host runtime of targetdiarization_tpu_torch, a copy of the
// JAX package's native/tdaudio.cpp with the same extern "C" functions.
// It covers the host work of the streaming path, which runs once a 1 s
// chunk (TargetDiarizationStream) and on every preprocessed clip:
//
//   * PCM int16 <-> float32 conversion (WS protocol marshalling)
//   * ITU-R BS.1770-4 gated integrated loudness (the streaming loudness
//     gate, AudioProcessor's loudness control, the separator's ordering
//     of its streams)
//   * a lock-free SPSC ring buffer for streaming ingest
//   * a linear resampler for quick host-side rate conversion
//
// Built at first use by utils/native.py (g++ -O3 -shared -fPIC -std=c++17
// -ffp-contract=off) into the package's _build/ directory and bound with
// ctypes; each function has a numpy version beside it there.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------- PCM conversion ----------------

void pcm16_to_f32(const int16_t* in, float* out, size_t n) {
    const float scale = 1.0f / 32768.0f;
    for (size_t i = 0; i < n; ++i) out[i] = in[i] * scale;
}

void f32_to_pcm16(const float* in, int16_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        float v = in[i] * 32768.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        out[i] = (int16_t)lrintf(v);
    }
}

// ---------------- BS.1770-4 loudness ----------------

struct Biquad {
    double b0, b1, b2, a1, a2;
};

// K-weighting coefficients for arbitrary sample rate — same analog
// prototypes as ops/loudness.py::_k_weighting_sos (shelf + RLB highpass).
static void k_weighting(int sr, Biquad* shelf, Biquad* hp) {
    {
        const double f0 = 1681.9744509555319, G = 3.99984385397,
                     Q = 0.7071752369554193;
        const double K = tan(M_PI * f0 / sr);
        const double Vh = pow(10.0, G / 20.0);
        const double Vb = pow(Vh, 0.499666774155);
        const double a0 = 1.0 + K / Q + K * K;
        shelf->b0 = (Vh + Vb * K / Q + K * K) / a0;
        shelf->b1 = 2.0 * (K * K - Vh) / a0;
        shelf->b2 = (Vh - Vb * K / Q + K * K) / a0;
        shelf->a1 = 2.0 * (K * K - 1.0) / a0;
        shelf->a2 = (1.0 - K / Q + K * K) / a0;
    }
    {
        const double f0 = 38.13547087602444, Q = 0.5003270373238773;
        const double K = tan(M_PI * f0 / sr);
        const double a0 = 1.0 + K / Q + K * K;
        hp->b0 = 1.0;
        hp->b1 = -2.0;
        hp->b2 = 1.0;
        hp->a1 = 2.0 * (K * K - 1.0) / a0;
        hp->a2 = (1.0 - K / Q + K * K) / a0;
    }
}

static void biquad_apply(const Biquad& q, const float* x, double* y, size_t n) {
    double x1 = 0, x2 = 0, y1 = 0, y2 = 0;
    for (size_t i = 0; i < n; ++i) {
        const double xi = x[i];
        const double yi = q.b0 * xi + q.b1 * x1 + q.b2 * x2 - q.a1 * y1 - q.a2 * y2;
        x2 = x1; x1 = xi;
        y2 = y1; y1 = yi;
        y[i] = yi;
    }
}

static void biquad_apply_d(const Biquad& q, const double* x, double* y, size_t n) {
    double x1 = 0, x2 = 0, y1 = 0, y2 = 0;
    for (size_t i = 0; i < n; ++i) {
        const double xi = x[i];
        const double yi = q.b0 * xi + q.b1 * x1 + q.b2 * x2 - q.a1 * y1 - q.a2 * y2;
        x2 = x1; x1 = xi;
        y2 = y1; y1 = yi;
        y[i] = yi;
    }
}

// Gated integrated loudness (LUFS) of mono audio. Returns -INFINITY
// when every block is gated out or the signal is too short.
double integrated_loudness(const float* x, size_t n, int sr) {
    if (n == 0) return -INFINITY;
    Biquad shelf, hp;
    k_weighting(sr, &shelf, &hp);
    std::vector<double> tmp(n), y(n);
    biquad_apply(shelf, x, tmp.data(), n);
    biquad_apply_d(hp, tmp.data(), y.data(), n);

    const size_t t_g = (size_t)(0.4 * sr);  // 400 ms
    if (n < t_g) {  // too short to gate: full-signal power (ops parity)
        double z = 0;
        for (size_t i = 0; i < n; ++i) z += y[i] * y[i];
        z /= (double)n;
        return -0.691 + 10.0 * log10(z > 1e-12 ? z : 1e-12);
    }
    const size_t hop = t_g / 4;  // 75% overlap
    const size_t n_blocks = 1 + (n - t_g) / hop;

    // prefix sums of y^2 for O(1) block power
    std::vector<double> cum(n + 1, 0.0);
    for (size_t i = 0; i < n; ++i) cum[i + 1] = cum[i] + y[i] * y[i];

    std::vector<double> z(n_blocks);
    std::vector<double> l(n_blocks);
    for (size_t b = 0; b < n_blocks; ++b) {
        const size_t s = b * hop;
        z[b] = (cum[s + t_g] - cum[s]) / (double)t_g;
        l[b] = -0.691 + 10.0 * log10(z[b] > 1e-30 ? z[b] : 1e-30);
    }
    // absolute gate at -70 LKFS
    double z_abs = 0; size_t n_abs = 0;
    for (size_t b = 0; b < n_blocks; ++b)
        if (l[b] > -70.0) { z_abs += z[b]; ++n_abs; }
    if (n_abs == 0) return -INFINITY;
    z_abs /= (double)n_abs;
    const double gamma_r = -0.691 + 10.0 * log10(z_abs > 1e-30 ? z_abs : 1e-30) - 10.0;
    // relative gate
    double z_rel = 0; size_t n_rel = 0;
    for (size_t b = 0; b < n_blocks; ++b)
        if (l[b] > -70.0 && l[b] > gamma_r) { z_rel += z[b]; ++n_rel; }
    if (n_rel == 0) return -INFINITY;
    z_rel /= (double)n_rel;
    return -0.691 + 10.0 * log10(z_rel > 1e-30 ? z_rel : 1e-30);
}

// ---------------- linear resampler (host quick path) ----------------

// Resample n_in samples to n_out samples by linear interpolation.
void resample_linear(const float* in, size_t n_in, float* out, size_t n_out) {
    if (n_in == 0 || n_out == 0) return;
    if (n_in == 1) { for (size_t i = 0; i < n_out; ++i) out[i] = in[0]; return; }
    const double step = (double)(n_in - 1) / (double)(n_out - 1 ? n_out - 1 : 1);
    for (size_t i = 0; i < n_out; ++i) {
        const double pos = i * step;
        size_t lo = (size_t)pos;
        if (lo >= n_in - 1) lo = n_in - 2;
        const double frac = pos - lo;
        out[i] = (float)((1.0 - frac) * in[lo] + frac * in[lo + 1]);
    }
}

// ---------------- SPSC ring buffer ----------------

struct RingBuffer {
    std::vector<float> data;
    size_t capacity;
    std::atomic<size_t> head{0};  // write index (producer)
    std::atomic<size_t> tail{0};  // read index (consumer)
};

void* ring_create(size_t capacity) {
    RingBuffer* rb = new RingBuffer();
    rb->capacity = capacity + 1;  // one-slot gap distinguishes full/empty
    rb->data.resize(rb->capacity);
    return rb;
}

void ring_free(void* h) { delete (RingBuffer*)h; }

size_t ring_size(void* h) {
    RingBuffer* rb = (RingBuffer*)h;
    const size_t head = rb->head.load(std::memory_order_acquire);
    const size_t tail = rb->tail.load(std::memory_order_acquire);
    return (head + rb->capacity - tail) % rb->capacity;
}

size_t ring_space(void* h) {
    RingBuffer* rb = (RingBuffer*)h;
    return rb->capacity - 1 - ring_size(h);
}

// Returns number of samples actually written.
size_t ring_push(void* h, const float* x, size_t n) {
    RingBuffer* rb = (RingBuffer*)h;
    const size_t space = ring_space(h);
    if (n > space) n = space;
    size_t head = rb->head.load(std::memory_order_relaxed);
    for (size_t i = 0; i < n; ++i) {
        rb->data[head] = x[i];
        head = (head + 1) % rb->capacity;
    }
    rb->head.store(head, std::memory_order_release);
    return n;
}

// Returns number of samples actually read.
size_t ring_pop(void* h, float* out, size_t n) {
    RingBuffer* rb = (RingBuffer*)h;
    const size_t avail = ring_size(h);
    if (n > avail) n = avail;
    size_t tail = rb->tail.load(std::memory_order_relaxed);
    for (size_t i = 0; i < n; ++i) {
        out[i] = rb->data[tail];
        tail = (tail + 1) % rb->capacity;
    }
    rb->tail.store(tail, std::memory_order_release);
    return n;
}

}  // extern "C"
