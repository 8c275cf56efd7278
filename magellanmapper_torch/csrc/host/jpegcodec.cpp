// JPEG codec shim over the system libjpeg(-turbo) for proprietary
// container imports: CZI compression id 1 stores baseline JFIF streams
// per subblock (ZISRAW spec; the upstream MagellanMapper decodes them
// through Bioformats' JPEGCodec on a JVM, magmap/io/importer.py:97-156).
// The port's copy of magellanmapper_tpu/native/jpegcodec.cpp.
//
// The port builds this file with g++ -ljpeg at first use and loads it
// with ctypes (io/_jpegcodec.py), so every entry point is a flat C
// function over caller-owned buffers. libjpeg's default error handler
// exit()s the process; each call installs a setjmp trampoline instead
// so corrupt streams return -1.

#include <csetjmp>
#include <cstdio>   // jpeglib.h references FILE without including it
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
    longjmp(reinterpret_cast<ErrMgr*>(cinfo->err)->jb, 1);
}

}  // namespace

extern "C" {

// Parse the stream header only: fills w/h/ncomp. 0 ok, -1 bad stream.
int jpegcodec_info(const unsigned char* src, unsigned long n,
                   int* w, int* h, int* ncomp) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, src, n);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    *w = static_cast<int>(cinfo.image_width);
    *h = static_cast<int>(cinfo.image_height);
    *ncomp = cinfo.num_components;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode the full stream into dst (row-major, components interleaved).
// Returns bytes written, or -1 on a bad stream / undersized dst.
long jpegcodec_decode(const unsigned char* src, unsigned long n,
                      unsigned char* dst, unsigned long cap) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, src, n);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_start_decompress(&cinfo);
    const unsigned long stride =
        static_cast<unsigned long>(cinfo.output_width) *
        cinfo.output_components;
    const unsigned long need = stride * cinfo.output_height;
    if (need > cap) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = dst + cinfo.output_scanline * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return static_cast<long>(need);
}

// Encode an 8-bit image (ncomp 1 = grayscale, 3 = RGB) into dst.
// Returns bytes written; -needed when cap is too small; -1 on error.
long jpegcodec_encode(const unsigned char* src, int w, int h,
                      int ncomp, int quality,
                      unsigned char* dst, unsigned long cap) {
    if (ncomp != 1 && ncomp != 3) return -1;
    jpeg_compress_struct cinfo;
    ErrMgr jerr;
    unsigned char* out = nullptr;
    unsigned long outsize = 0;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_compress(&cinfo);
        free(out);
        return -1;
    }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &out, &outsize);
    cinfo.image_width = static_cast<JDIMENSION>(w);
    cinfo.image_height = static_cast<JDIMENSION>(h);
    cinfo.input_components = ncomp;
    cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    const unsigned long stride =
        static_cast<unsigned long>(w) * ncomp;
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<unsigned char*>(
            src + cinfo.next_scanline * stride);
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    long ret;
    if (outsize > cap) {
        ret = -static_cast<long>(outsize);
    } else {
        memcpy(dst, out, outsize);
        ret = static_cast<long>(outsize);
    }
    free(out);
    return ret;
}

}  // extern "C"
