/* nbrt — native host runtime of the nblic_tpu framework.
 *
 * C API consumed via ctypes from Python (no pybind11 in this environment).
 * Implements the two interop containers of the NBLIC format family:
 *   - "Q0.2"     : effort-0 engine (static rANS)          [spec: reference src/QNBLIC.c]
 *   - "NBLIC0.3" : effort-1..3 engine (adaptive range coder) [spec: reference src/NBLIC.c]
 *
 * All functions return a non-negative byte count on success or a negative
 * error code: -1 invalid parameters / malformed stream, -2 output capacity
 * exceeded, -3 internal failure.
 */
#ifndef NBRT_H
#define NBRT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Effort-0 encoder. n_threads <= 1 selects the single-threaded path; larger
 * values enable the band-parallel stage-1 pipeline (bit-identical output). */
int64_t nbrt_q_encode(const uint8_t* img, int32_t height, int32_t width,
                      uint8_t* out, int64_t out_cap, int32_t n_threads);

int64_t nbrt_q_decode(const uint8_t* stream, int64_t stream_len,
                      uint8_t* img_out, int64_t img_cap,
                      int32_t* height, int32_t* width);

/* Effort-1..3 encoder (near 0..9; near>0 is near-lossless). When img_rec is
 * non-NULL it receives the decoder-visible reconstruction (H*W bytes). */
int64_t nbrt_n_encode(const uint8_t* img, int32_t height, int32_t width,
                      int32_t near, int32_t effort,
                      uint8_t* out, int64_t out_cap, uint8_t* img_rec);

int64_t nbrt_n_decode(const uint8_t* stream, int64_t stream_len,
                      uint8_t* img_out, int64_t img_cap,
                      int32_t* height, int32_t* width,
                      int32_t* near, int32_t* effort);

/* Modeling pass of the effort-0 engine without entropy coding: emits per-pixel
 * (qd, y) planes and the 12x256 histogram. Used to cross-check the TPU modeling
 * kernels and to feed device-side entropy experiments. */
int64_t nbrt_q_model(const uint8_t* img, int32_t height, int32_t width,
                     uint8_t* qd_out, uint8_t* y_out, uint32_t* hist_out /*12*256*/);

const char* nbrt_version(void);

#ifdef __cplusplus
}
#endif

#endif /* NBRT_H */
