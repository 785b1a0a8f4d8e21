// The card's NVDEC video decoder capabilities, for a codec in 8-bit 4:2:0:
// the driver's cuvidGetDecoderCaps, loaded from libnvcuvid.so.1 with dlopen
// and declared by nvcuvid_api.h, in the device's primary context (the one
// PyTorch uses).
//
// The port decodes H.264 and MPEG-4 part 2 only where NVDEC answers here.
// On the H100 machines this repository is measured on it does not: the
// container grants the driver's compute and utility capabilities but not
// video, and cuvidGetDecoderCaps (like cuvidCreateDecoder) returns
// CUDA_ERROR_OUT_OF_MEMORY for every codec (ROADMAP.md queue A9).
// chip_smoke.py's decode line records what it answers on each run.
//
// Every CUresult that is not CUDA_SUCCESS is an error: nvdec_caps returns -1
// with its text, naming this file, in the caller's buffer.
//
// Build (data/native/__init__.py): g++ -O3 -fPIC -shared -std=c++17
// nvdec.cpp -I$CUDA/include -L$CUDA/lib64/stubs -lcuda -ldl

#include <dlfcn.h>

#include <cstdio>
#include <cstring>
#include <string>

#include "nvcuvid_api.h"

namespace {

std::string cu_text(CUresult r, const char *what) {
  const char *name = nullptr;
  cuGetErrorName(r, &name);
  return std::string("nvdec.cpp: ") + what + " returned CUresult " +
         std::to_string((int)r) + " (" + (name ? name : "unknown") + ")";
}

int fail(char *err, int n, const std::string &text) {
  if (err && n > 0) snprintf(err, (size_t)n, "%s", text.c_str());
  return -1;
}

}  // namespace

extern "C" {

// out[0..7] = bIsSupported, nNumNVDECs, nOutputFormatMask, nMaxWidth,
// nMaxHeight, nMaxMBCount, nMinWidth, nMinHeight for ``codec``
// (cudaVideoCodec) in 8-bit 4:2:0 on ``device``. 0, or -1.
int nvdec_caps(int device, int codec, unsigned int *out, char *err, int n) {
  static void *lib = dlopen("libnvcuvid.so.1", RTLD_NOW | RTLD_LOCAL);
  if (!lib) {
    const char *why = dlerror();
    return fail(err, n, std::string("nvdec.cpp: dlopen(libnvcuvid.so.1) "
                                    "failed: ") + (why ? why : "?"));
  }
  auto caps_fn = reinterpret_cast<PFN_cuvidGetDecoderCaps>(
      dlsym(lib, "cuvidGetDecoderCaps"));
  if (!caps_fn)
    return fail(err, n, "nvdec.cpp: libnvcuvid.so.1 has no "
                        "cuvidGetDecoderCaps");
  CUdevice dev;
  CUcontext ctx, popped;
  CUresult r = cuInit(0);
  if (r != CUDA_SUCCESS) return fail(err, n, cu_text(r, "cuInit"));
  if ((r = cuDeviceGet(&dev, device)) != CUDA_SUCCESS)
    return fail(err, n, cu_text(r, "cuDeviceGet"));
  if ((r = cuDevicePrimaryCtxRetain(&ctx, dev)) != CUDA_SUCCESS)
    return fail(err, n, cu_text(r, "cuDevicePrimaryCtxRetain"));
  std::string error;
  if ((r = cuCtxPushCurrent(ctx)) != CUDA_SUCCESS) {
    error = cu_text(r, "cuCtxPushCurrent");
  } else {
    CUVIDDECODECAPS caps;
    memset(&caps, 0, sizeof caps);
    caps.eCodecType = (cudaVideoCodec)codec;
    caps.eChromaFormat = cudaVideoChromaFormat_420;
    if ((r = caps_fn(&caps)) != CUDA_SUCCESS) {
      error = cu_text(r, "cuvidGetDecoderCaps");
    } else {
      const unsigned vals[8] = {caps.bIsSupported, caps.nNumNVDECs,
                                caps.nOutputFormatMask, caps.nMaxWidth,
                                caps.nMaxHeight, caps.nMaxMBCount,
                                caps.nMinWidth, caps.nMinHeight};
      memcpy(out, vals, sizeof vals);
    }
    cuCtxPopCurrent(&popped);
  }
  cuDevicePrimaryCtxRelease(dev);
  return error.empty() ? 0 : fail(err, n, error);
}

}  // extern "C"
