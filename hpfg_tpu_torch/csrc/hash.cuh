// The dropout hash shared by every kernel of hpfg_tpu_torch/csrc, so the
// ConvBlock masks (conv3x3.cu) and the attention-dropout masks
// (window_attention.cu) cannot drift apart.
//
// It is the JAX package's _hash_mask (hpfg_tpu/ops/pallas/conv_block.py):
// the murmur3-style finalizer of v = row * lanes + lane plus
// (seed + b_idx * 0x9E3779B9), in uint32; the element is kept (scaled by
// 1/keep) when the result is below thresh = keep * 2^32. b_idx is the image
// for a ConvBlock mask and (window block) * 1024 + head for an attention
// mask: an index of the data, never of the CUDA grid. Under data
// parallelism a ConvBlock mask's image is its index in the GLOBAL batch
// (image_index: ids[b] from the wrapper's image-id map, or the local b
// without one), so each image gets the mask it gets in one process. The
// plain versions are hash_keep and hash_mask in
// hpfg_tpu_torch/ops/conv_block.py.

#pragma once

#include <stdint.h>

// The image index a ConvBlock mask hashes for local image b: ids[b] (int32
// [B], each local image's index in the global batch) or b itself.
static __device__ __forceinline__ int image_index(const int* ids, int b) {
  return ids != nullptr ? ids[b] : b;
}

static __device__ __forceinline__ float hash_keep(uint32_t seed,
                                                  uint32_t thresh, float scale,
                                                  int b_idx, int row,
                                                  int lanes, int lane) {
  uint32_t v = (uint32_t)(row * lanes + lane);
  uint32_t x = v + (seed + (uint32_t)b_idx * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < thresh ? scale : 0.f;
}
