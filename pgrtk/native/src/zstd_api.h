// The five functions of zstd's stable API that this library calls.
// Where zstd's development headers are installed they declare them; a
// machine with only the runtime library (libzstd.so.1, e.g. Debian's
// libzstd1 package) gets the same declarations from here.  These
// signatures are part of zstd's stable ABI since v1.0.
#pragma once

#if __has_include(<zstd.h>)
#include <zstd.h>
#else
#include <cstddef>

extern "C" {
size_t ZSTD_compress(void *dst, size_t dstCapacity, const void *src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void *dst, size_t dstCapacity, const void *src,
                       size_t compressedSize);
size_t ZSTD_findFrameCompressedSize(const void *src, size_t srcSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);
}
#endif
