// Native runtime for the JAX LoRa framework: high-rate IQ ingest, format
// conversion and overlap-save blocking, feeding the JAX compute path.
//
// The reference's native layer is its C++ modem core; here the modem math
// lives on the accelerator (JAX), and the native layer owns what the
// accelerator should not: byte-stream ingest, sample-format conversion (interleaved
// cf32 / int16 / int8 -> planar float32), ring buffering of continuous
// streams, and overlap-save block emission with halos for the time-sharded
// demodulator (SURVEY.md §5.7a). Zero allocations on the steady-state path
// (the reference's zero-alloc contract, tests/no_alloc_test.cpp, carried
// over): all buffers are created at setup time.
//
// Plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <atomic>

extern "C" {

// ---------------------------------------------------------------------------
// Sample-format conversion (interleaved IQ -> planar float32)
// ---------------------------------------------------------------------------

// float32 interleaved (re, im) pairs -> split planes
void lora_rt_cf32_to_planar(const float* interleaved, size_t n_samples,
                            float* re, float* im) {
    for (size_t i = 0; i < n_samples; ++i) {
        re[i] = interleaved[2 * i];
        im[i] = interleaved[2 * i + 1];
    }
}

// int16 interleaved IQ -> planar float32 scaled to [-1, 1]
void lora_rt_ci16_to_planar(const int16_t* interleaved, size_t n_samples,
                            float scale, float* re, float* im) {
    const float k = scale / 32768.0f;
    for (size_t i = 0; i < n_samples; ++i) {
        re[i] = k * (float)interleaved[2 * i];
        im[i] = k * (float)interleaved[2 * i + 1];
    }
}

// int8 interleaved IQ -> planar float32 scaled to [-1, 1]
void lora_rt_ci8_to_planar(const int8_t* interleaved, size_t n_samples,
                           float scale, float* re, float* im) {
    const float k = scale / 128.0f;
    for (size_t i = 0; i < n_samples; ++i) {
        re[i] = k * (float)interleaved[2 * i];
        im[i] = k * (float)interleaved[2 * i + 1];
    }
}

// planar float32 -> interleaved cf32 (TX side)
void lora_rt_planar_to_cf32(const float* re, const float* im,
                            size_t n_samples, float* interleaved) {
    for (size_t i = 0; i < n_samples; ++i) {
        interleaved[2 * i] = re[i];
        interleaved[2 * i + 1] = im[i];
    }
}

// ---------------------------------------------------------------------------
// Overlap-save stream ring
// ---------------------------------------------------------------------------
// Single-producer single-consumer ring of planar samples. The consumer
// pops fixed blocks of `block` samples prefixed with the previous block's
// last `halo` samples (overlap-save), matching the halo contract of the
// time-sharded demodulator.

struct LoraRing {
    float* re;
    float* im;
    size_t capacity;      // samples
    size_t block;         // emitted block size
    size_t halo;          // overlap carried between blocks
    std::atomic<uint64_t> head;   // total samples written
    std::atomic<uint64_t> tail;   // total samples consumed (block-aligned)
};

void* lora_rt_ring_create(size_t capacity, size_t block, size_t halo) {
    // `2*halo` headroom: the halo samples behind `tail` stay live until the
    // next pop re-reads them, so the producer may never reclaim them (see
    // lora_rt_ring_space).
    if (capacity < block + 2 * halo || block == 0) return nullptr;
    LoraRing* r = new LoraRing();
    r->re = (float*)malloc(capacity * sizeof(float));
    r->im = (float*)malloc(capacity * sizeof(float));
    r->capacity = capacity;
    r->block = block;
    r->halo = halo;
    r->head.store(0);
    r->tail.store(0);
    if (!r->re || !r->im) { free(r->re); free(r->im); delete r; return nullptr; }
    return r;
}

void lora_rt_ring_destroy(void* ring) {
    LoraRing* r = (LoraRing*)ring;
    if (!r) return;
    free(r->re);
    free(r->im);
    delete r;
}

// Space available for the producer (in samples). The `halo` samples behind
// `tail` are still owed to the consumer's next pop_block, so they are
// reserved: without this, a backpressured producer (push until space == 0)
// overwrites the halo region before pop_block reads it and every block seam
// after the first wrap silently returns future samples as its halo.
size_t lora_rt_ring_space(void* ring) {
    LoraRing* r = (LoraRing*)ring;
    uint64_t reserved = r->head.load() - r->tail.load() + r->halo;
    return reserved >= r->capacity ? 0 : (size_t)(r->capacity - reserved);
}

// Push planar samples; returns samples accepted (may be < n when full).
size_t lora_rt_ring_push(void* ring, const float* re, const float* im,
                         size_t n) {
    LoraRing* r = (LoraRing*)ring;
    size_t space = lora_rt_ring_space(ring);
    if (n > space) n = space;
    uint64_t head = r->head.load();
    for (size_t i = 0; i < n; ++i) {
        size_t pos = (size_t)((head + i) % r->capacity);
        r->re[pos] = re[i];
        r->im[pos] = im[i];
    }
    r->head.store(head + n);
    return n;
}

// Samples ready beyond the already-consumed point.
size_t lora_rt_ring_ready(void* ring) {
    LoraRing* r = (LoraRing*)ring;
    return (size_t)(r->head.load() - r->tail.load());
}

// Pop one overlap-save block: writes `halo + block` planar samples into
// out_re/out_im (halo from before the consume point, zeros before stream
// start). Returns 1 on success, 0 if not enough data buffered.
int lora_rt_ring_pop_block(void* ring, float* out_re, float* out_im) {
    LoraRing* r = (LoraRing*)ring;
    uint64_t tail = r->tail.load();
    if (r->head.load() - tail < r->block) return 0;
    // halo section (may precede stream start -> zero fill)
    for (size_t i = 0; i < r->halo; ++i) {
        int64_t src = (int64_t)tail - (int64_t)r->halo + (int64_t)i;
        if (src < 0) {
            out_re[i] = 0.0f;
            out_im[i] = 0.0f;
        } else {
            size_t pos = (size_t)(src % (int64_t)r->capacity);
            out_re[i] = r->re[pos];
            out_im[i] = r->im[pos];
        }
    }
    for (size_t i = 0; i < r->block; ++i) {
        size_t pos = (size_t)((tail + i) % r->capacity);
        out_re[r->halo + i] = r->re[pos];
        out_im[r->halo + i] = r->im[pos];
    }
    r->tail.store(tail + r->block);
    return 1;
}

// Absolute sample index of the next block's first (non-halo) sample.
uint64_t lora_rt_ring_position(void* ring) {
    return ((LoraRing*)ring)->tail.load();
}

// ---------------------------------------------------------------------------
// File ingest: read interleaved cf32 file directly into planar batches
// ---------------------------------------------------------------------------

// Reads up to n_samples IQ pairs from a file at byte offset; returns
// samples read. format: 0 = cf32, 1 = ci16, 2 = ci8.
long lora_rt_read_iq_file(const char* path, long offset_samples,
                          long n_samples, int format, float scale,
                          float* re, float* im) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    const size_t unit = format == 0 ? 8 : (format == 1 ? 4 : 2);
    if (fseek(f, (long)(offset_samples * (long)unit), SEEK_SET) != 0) {
        fclose(f);
        return -1;
    }
    const size_t CHUNK = 1 << 16;
    void* buf = malloc(CHUNK * unit);
    long total = 0;
    while (total < n_samples) {
        size_t want = (size_t)(n_samples - total) < CHUNK
                          ? (size_t)(n_samples - total) : CHUNK;
        size_t got = fread(buf, unit, want, f);
        if (got == 0) break;
        if (format == 0)
            lora_rt_cf32_to_planar((const float*)buf, got, re + total, im + total);
        else if (format == 1)
            lora_rt_ci16_to_planar((const int16_t*)buf, got, scale, re + total,
                                   im + total);
        else
            lora_rt_ci8_to_planar((const int8_t*)buf, got, scale, re + total,
                                  im + total);
        total += (long)got;
        if (got < want) break;
    }
    free(buf);
    fclose(f);
    return total;
}

}  // extern "C"
