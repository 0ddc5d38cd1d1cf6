// Plain C entry points of the port's CUDA kernels, loaded from Python with
// ctypes (incubator_mxnet_tpu_torch/ops/cuda/common.py). Pointers are
// tensor data pointers and the stream is PyTorch's current CUDA stream;
// the Python wrappers check device, dtype, shape, contiguity and alignment
// before calling. Every function returns a cudaError_t as int (0 = success),
// read right after the launch. This file includes no PyTorch header, so it
// compiles in seconds.

int decode_attention_launch(int paged, int dtype, const void* q,
                            const void* k, const void* v, void* out,
                            const int* lengths, const int* block_tables,
                            int S, int H, int d, int block_k, int n_blocks,
                            int n_pool, float scale, void* stream);
const char* decode_attention_error_string(int code);

int flash_attention_launch(int kind, int layout, int dtype, const void* q,
                           const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* o0,
                           void* o1, float* lse_out, int B, int H, int sq,
                           int sk, int d, int causal, float scale,
                           void* stream);

extern "C" {

// q (S, H, d); k/v (S, H, n_blocks * block_k, d); lengths (S,) int32.
int mxt_flash_decode_step(const void* q, const void* k, const void* v,
                          void* out, const void* lengths, int S, int H,
                          int d, int block_k, int n_blocks, int dtype,
                          float scale, void* stream) {
  return decode_attention_launch(0, dtype, q, k, v, out,
                                 static_cast<const int*>(lengths), nullptr,
                                 S, H, d, block_k, n_blocks, 1, scale,
                                 stream);
}

// q (S, H, d); k/v (n_pool, H, page_len, d); block_tables (S, max_pages)
// int32; lengths (S,) int32.
int mxt_flash_decode_step_paged(const void* q, const void* k, const void* v,
                                void* out, const void* block_tables,
                                const void* lengths, int S, int H, int d,
                                int page_len, int max_pages, int n_pool,
                                int dtype, float scale, void* stream) {
  return decode_attention_launch(1, dtype, q, k, v, out,
                                 static_cast<const int*>(lengths),
                                 static_cast<const int*>(block_tables), S, H,
                                 d, page_len, max_pages, n_pool, scale,
                                 stream);
}

// Training attention. layout 0: q/k/v (B, T, H*d), lse/delta (B, T, H)
// float32; layout 1: q/k/v (B, H, T, d), lse/delta (B, H, T). k/v have
// sk rows, q/dout sq rows. Outputs have their input's layout and type.
int mxt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int H, int sq, int sk, int d, int layout,
                  int causal, int dtype, float scale, void* stream) {
  return flash_attention_launch(0, layout, dtype, q, k, v, nullptr, nullptr,
                                nullptr, out, nullptr,
                                static_cast<float*>(lse), B, H, sq, sk, d,
                                causal, scale, stream);
}

int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int sq, int sk, int d,
                     int layout, int causal, int dtype, float scale,
                     void* stream) {
  return flash_attention_launch(1, layout, dtype, q, k, v, dout,
                                static_cast<const float*>(lse),
                                static_cast<const float*>(delta), dq,
                                nullptr, nullptr, B, H, sq, sk, d, causal,
                                scale, stream);
}

int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int sq, int sk,
                      int d, int layout, int causal, int dtype, float scale,
                      void* stream) {
  return flash_attention_launch(2, layout, dtype, q, k, v, dout,
                                static_cast<const float*>(lse),
                                static_cast<const float*>(delta), dk, dv,
                                nullptr, B, H, sq, sk, d, causal, scale,
                                stream);
}

const char* mxt_cuda_error_string(int code) {
  return decode_attention_error_string(code);
}

}  // extern "C"
