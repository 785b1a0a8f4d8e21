// The part of NVIDIA's video decoder API (NVDEC, "NVCUVID") that nvdec.cpp
// uses, declared here so that the build needs only the CUDA toolkit's
// cuda.h and the driver's libnvcuvid.so.1, not the Video Codec SDK's
// headers: the decoder capability query.
//
// Written from NVIDIA's public Video Codec SDK documentation: "NVDEC Video
// Decoder API Programming Guide", section "Querying decode capabilities",
// and the CUVIDDECODECAPS reference of cuviddec.h that it documents. The
// field order, types and reserved padding follow that reference; the
// reserved array keeps the structure at its documented size. The function
// is looked up with dlsym at run time (nvdec.cpp), so nothing here is
// linked.
#pragma once

#include <cuda.h>

extern "C" {

typedef enum cudaVideoCodec_enum {
  cudaVideoCodec_MPEG1 = 0,
  cudaVideoCodec_MPEG2,
  cudaVideoCodec_MPEG4,
  cudaVideoCodec_VC1,
  cudaVideoCodec_H264,
  cudaVideoCodec_JPEG,
  cudaVideoCodec_H264_SVC,
  cudaVideoCodec_H264_MVC,
  cudaVideoCodec_HEVC,
  cudaVideoCodec_VP8,
  cudaVideoCodec_VP9,
  cudaVideoCodec_AV1
} cudaVideoCodec;

typedef enum cudaVideoChromaFormat_enum {
  cudaVideoChromaFormat_Monochrome = 0,
  cudaVideoChromaFormat_420,
  cudaVideoChromaFormat_422,
  cudaVideoChromaFormat_444
} cudaVideoChromaFormat;

// cuviddec.h: what cuvidGetDecoderCaps reports for a codec, chroma format
// and bit depth.
typedef struct _CUVIDDECODECAPS {
  cudaVideoCodec eCodecType;              // IN
  cudaVideoChromaFormat eChromaFormat;    // IN
  unsigned int nBitDepthMinus8;           // IN
  unsigned int reserved1[3];
  unsigned char bIsSupported;             // OUT: 1 if supported
  unsigned char nNumNVDECs;               // OUT
  unsigned short nOutputFormatMask;       // OUT: bit k = surface format k
  unsigned int nMaxWidth;                 // OUT: coded width
  unsigned int nMaxHeight;                // OUT: coded height
  unsigned int nMaxMBCount;               // OUT
  unsigned short nMinWidth;               // OUT
  unsigned short nMinHeight;              // OUT
  unsigned char bIsHistogramSupported;
  unsigned char nCounterBitDepth;
  unsigned short nMaxHistogramBins;
  unsigned int reserved3[10];
} CUVIDDECODECAPS;

typedef CUresult (*PFN_cuvidGetDecoderCaps)(CUVIDDECODECAPS *);

}  // extern "C"

static_assert(sizeof(CUVIDDECODECAPS) == 88, "CUVIDDECODECAPS layout");
