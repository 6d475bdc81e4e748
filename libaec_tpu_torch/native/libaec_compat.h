/* libaec/szlib-compatible C API of libaec_tpu's native codec.
 *
 * Drop-in header for C consumers: the struct layouts, names, flags and
 * error codes match the reference libaec public interface
 * (libaec's src/libaec.h, szlib.h) so existing code can link
 * against libaectpu.so unchanged.  The implementation is this
 * framework's own native codec (aectpu_native.cpp / encoder.cpp /
 * libaec_abi.cpp).
 *
 * Streaming note: aec_encode/aec_decode buffer internally at RSI
 * granularity (output is byte-identical to one-shot; input and output
 * may be drip-fed with AEC_NO_FLUSH exactly like the reference), rather
 * than resuming mid-bit like the reference FSM.
 */
#ifndef LIBAEC_TPU_COMPAT_H
#define LIBAEC_TPU_COMPAT_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

struct internal_state;

struct aec_stream {
    const unsigned char *next_in;
    size_t avail_in;   /* number of bytes available at next_in */
    size_t total_in;   /* total number of input bytes read so far */
    unsigned char *next_out;
    size_t avail_out;  /* remaining free space at next_out */
    size_t total_out;  /* total number of bytes output so far */
    unsigned int bits_per_sample;  /* 1, ..., 32 */
    unsigned int block_size;       /* in samples */
    unsigned int rsi;              /* reference sample interval, <= 4096 */
    unsigned int flags;
    struct internal_state *state;
};

/* Sample data description flags */
#define AEC_DATA_SIGNED 1
#define AEC_DATA_3BYTE 2
#define AEC_DATA_MSB 4
#define AEC_DATA_PREPROCESS 8
#define AEC_RESTRICTED 16
#define AEC_PAD_RSI 32
#define AEC_NOT_ENFORCE 64

/* Return codes */
#define AEC_OK 0
#define AEC_CONF_ERROR (-1)
#define AEC_STREAM_ERROR (-2)
#define AEC_DATA_ERROR (-3)
#define AEC_MEM_ERROR (-4)

/* Options for flushing */
#define AEC_NO_FLUSH 0
#define AEC_FLUSH 1

int aec_encode_init(struct aec_stream *strm);
int aec_encode(struct aec_stream *strm, int flush);
int aec_encode_end(struct aec_stream *strm);
int aec_decode_init(struct aec_stream *strm);
int aec_decode(struct aec_stream *strm, int flush);
int aec_decode_end(struct aec_stream *strm);
int aec_buffer_encode(struct aec_stream *strm);
int aec_buffer_decode(struct aec_stream *strm);

/* ---- szlib compatibility ---- */

#define SZ_ALLOW_K13_OPTION_MASK 1
#define SZ_CHIP_OPTION_MASK 2
#define SZ_EC_OPTION_MASK 4
#define SZ_LSB_OPTION_MASK 8
#define SZ_MSB_OPTION_MASK 16
#define SZ_NN_OPTION_MASK 32
#define SZ_RAW_OPTION_MASK 128

#define SZ_OK AEC_OK
#define SZ_OUTBUFF_FULL 2
#define SZ_NO_ENCODER_ERROR (-1)
#define SZ_PARAM_ERROR AEC_CONF_ERROR
#define SZ_MEM_ERROR AEC_MEM_ERROR

#define SZ_MAX_PIXELS_PER_BLOCK 32
#define SZ_MAX_BLOCKS_PER_SCANLINE 128
#define SZ_MAX_PIXELS_PER_SCANLINE \
    ((SZ_MAX_BLOCKS_PER_SCANLINE) * (SZ_MAX_PIXELS_PER_BLOCK))

typedef struct SZ_com_t_s {
    int options_mask;
    int bits_per_pixel;
    int pixels_per_block;
    int pixels_per_scanline;
} SZ_com_t;

int SZ_BufftoBuffCompress(void *dest, size_t *destLen, const void *source,
                          size_t sourceLen, SZ_com_t *param);
int SZ_BufftoBuffDecompress(void *dest, size_t *destLen, const void *source,
                            size_t sourceLen, SZ_com_t *param);
int SZ_encoder_enabled(void);

#ifdef __cplusplus
}
#endif

#endif /* LIBAEC_TPU_COMPAT_H */
