/* The sampled triangle estimators' key chain on a host core, behind a
 * plain C interface.
 *
 * The JAX package splits the samplers' key at every step of a batch
 * (gelly_streaming_tpu/library/sampled_triangles.py:69, masked rows
 * included): the next key is threefry2x32 of the counter pair (0, 0) under
 * the current one.  Key t of a stream is therefore a function of the seed
 * and t alone, and the whole chain can be computed ahead of the data.  Each
 * hash depends on the one before, so the chain is latency-bound wherever it
 * runs: on a host core a dependent add, rotate or xor retires every cycle,
 * about ten times sooner than on an SM.  csrc/sampled_triangles.cu takes the
 * keys as its input.
 *
 * Built with the host C compiler (`cc -O2 -shared -fPIC`) into the port's
 * build directory and loaded with ctypes, which releases the GIL during the
 * call.
 */

#include <stdint.h>

static inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

/* threefry2x32 (20 rounds, a key injection every 4) of (x0, x1) under (k0, k1) */
static inline void threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1, uint32_t* out) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += k0;
    x1 += k1;
#define TF_ROUND(r)          \
    x0 += x1;                \
    x1 = rotl(x1, r) ^ x0;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k1;
    x1 += k2 + 1u;
    TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    x0 += k2;
    x1 += k0 + 2u;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k0;
    x1 += k1 + 3u;
    TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    x0 += k1;
    x1 += k2 + 4u;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k2;
    x1 += k0 + 5u;
#undef TF_ROUND
    out[0] = x0;
    out[1] = x1;
}

/* keys uint32[2 (n + 1)]: the key before each of n steps from (k0, k1),
 * then the key after them */
void threefry_chain(uint32_t k0, uint32_t k1, int64_t n, uint32_t* keys) {
    uint32_t k[2] = {k0, k1};
    for (int64_t t = 0; t < n; ++t) {
        keys[2 * t] = k[0];
        keys[2 * t + 1] = k[1];
        threefry(k[0], k[1], 0u, 0u, k);
    }
    keys[2 * n] = k[0];
    keys[2 * n + 1] = k[1];
}
