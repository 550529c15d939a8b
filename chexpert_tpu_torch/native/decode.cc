// Native JPEG decode for the input pipeline: the PyTorch port's copy of
// chexpert_tpu/native/decode.cc (the same C ABI and the same bytes).
//
// The reference decodes through PIL in 16 fork workers every epoch
// (reference chexpert.py:77). Here decode happens once (packed cache)
// or streamed; this library removes the Python object layer and exploits
// libjpeg's DCT-domain scaling: when the target size is <= 1/2, 1/4, 1/8 of
// the source, the IDCT itself produces the downscaled image — decisive for
// full-resolution CheXpert (2-3k px sources) where most decode work can be
// skipped entirely.
//
// Exposed C ABI (ctypes):
//   decode_jpeg_gray(buf, len, out, out_cap, &w, &h, min_edge_hint) -> 0/err
//     Decodes to 8-bit grayscale. If min_edge_hint > 0, picks the largest
//     libjpeg scale_denom in {1,2,4,8} such that min(w,h)/denom >= hint
//     (never scaling below the hint). Writes w*h bytes row-major into out.
//
// Build: chexpert_tpu_torch/native/__init__.py, at first use
// (g++ -O3 -shared -fPIC -o chexpert_tpu_torch/_build/decode-<hash>.so decode.cc -ljpeg).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

// Returns 0 on success; 1 decode error; 2 output buffer too small.
int decode_jpeg_gray(const uint8_t* buf, long len, uint8_t* out, long out_cap,
                     int* out_w, int* out_h, int min_edge_hint) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);

  cinfo.out_color_space = JCS_GRAYSCALE;
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  if (min_edge_hint > 0) {
    const int min_edge = cinfo.image_width < cinfo.image_height
                             ? cinfo.image_width
                             : cinfo.image_height;
    for (int denom = 8; denom >= 2; denom /= 2) {
      if (min_edge / denom >= min_edge_hint) {
        cinfo.scale_denom = denom;
        break;
      }
    }
  }
  // speed over last-bit fidelity for the scaled path
  cinfo.dct_method = JDCT_ISLOW;

  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  if (static_cast<long>(w) * h > out_cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long>(cinfo.output_scanline) * w;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_w = w;
  *out_h = h;
  return 0;
}

}  // extern "C"
