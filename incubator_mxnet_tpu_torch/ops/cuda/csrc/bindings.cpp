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
int decode_split_launch(int paged, int dtype, const void* q, const void* k,
                        const void* v, void* out, const int* lengths,
                        const int* block_tables, float* ws, int* tickets,
                        int S, int H, int d, int page_len, int n_pages,
                        int n_pool, int tile_rows, int tiles_per_split,
                        int n_split, float scale, void* stream);
const char* decode_attention_error_string(int code);

int flash_attention_launch(int kind, int layout, int dtype, int fma,
                           const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* o0, void* o1,
                           float* lse_out, int B, int H, int sq, int sk,
                           int d, int causal, float scale, void* stream);

int flash_fwd_sm90_launch(int layout, const void* q, const void* k,
                          const void* v, void* out, float* lse, int B, int H,
                          int sq, int sk, int d, int causal, float scale,
                          void* stream);

int flash_bwd_sm90_launch(int dkv, int layout, const void* q, const void* k,
                          const void* v, const void* dout, const float* lse,
                          const float* delta, void* o0, void* o1, int B,
                          int H, int sq, int sk, int d, int causal,
                          float scale, void* stream);

int layer_norm_fwd_launch(int dtype, const void* x, const float* gamma,
                          const float* beta, void* y, float* mu, float* rstd,
                          int n, int d, float eps, void* stream);
int layer_norm_fwd_vec_launch(int dtype, const void* x, const float* gamma,
                              const float* beta, void* y, float* mu,
                              float* rstd, int n, int d, float eps,
                              int rows_per_block, int blocks, void* stream);
int layer_norm_bwd_launch(int dtype, const void* x, const float* gamma,
                          const float* mu, const float* rstd, const void* dy,
                          void* dx, float* dg, float* db, int n, int d,
                          int rows_per_block, void* stream);
int layer_norm_bwd_onepass_launch(int dtype, const void* x,
                                  const float* gamma, const float* mu,
                                  const float* rstd, const void* dy, void* dx,
                                  float* dgamma, float* dbeta, float* ws,
                                  int* tickets, int n, int d,
                                  int rows_per_block, int blocks,
                                  void* stream);
int softmax_fwd_launch(int dtype, const void* x, void* y, int n, int d,
                       void* stream);
int conv_fused_fwd_launch(int dtype, int ks, const void* x, const float* a,
                          const float* b, const void* sc, const float* asc,
                          const float* bsc, const void* w, long long s_tap,
                          long long s_c, long long s_n, const float* bias,
                          void* y, float* stats, void* xhat, int M, int C,
                          int N, int H, int W, void* stream);
int conv_fused_dgrad_launch(int dtype, int ks, const void* g,
                            const void* dzn, const void* yout,
                            const float* gc, const void* w, long long s_tap,
                            long long s_c, long long s_n, const void* x,
                            const float* a, const float* b, const void* dsc,
                            const void* p0, const void* p1, int n_partners,
                            int mask, void* dz, float* part, int M, int C,
                            int N, int H, int W, void* stream);
int conv_fused_wgrad_launch(int dtype, int ks, const void* x,
                            const float* a, const float* b, const void* g,
                            const void* dzn, const void* yout,
                            const float* gc, float* ws, int splits,
                            int chunk, int M, int C, int N, int H, int W,
                            void* stream);
int conv_fused_dual_dgrad_launch(int dtype, const void* dzn_a,
                                 const void* yout_a, const float* gc_a,
                                 const void* w_a, long long s_c_a,
                                 long long s_n_a, const void* dzn_b,
                                 const void* yout_b, const float* gc_b,
                                 const void* w_b, long long s_c_b,
                                 long long s_n_b, void* dx, int M, int C,
                                 int Na, int Nb, void* stream);
int conv_fused_dual_wgrad_launch(int dtype, const void* x,
                                 const void* dzn_a, const void* yout_a,
                                 const float* gc_a, const void* dzn_b,
                                 const void* yout_b, const float* gc_b,
                                 float* ws, int splits, int chunk, int M,
                                 int C, int Na, int Nb, void* stream);
int conv_fused_sm90_fwd_launch(const void* x, const float* a, const float* b,
                               const void* sc, const float* asc,
                               const float* bsc, const void* w,
                               long long s_k, long long s_n,
                               const float* bias, void* y, float* stats,
                               void* xhat, int M, int K, int N, int bn,
                               void* stream);
int conv_fused_sm90_dual_dgrad_launch(
    const void* dzn_a, const void* yout_a, const float* gc_a,
    const void* w_a, long long s_c_a, long long s_n_a, void* g_a,
    const void* dzn_b, const void* yout_b, const float* gc_b,
    const void* w_b, long long s_c_b, long long s_n_b, void* g_b, void* dx,
    int M, int C, int Na, int Nb, int bn, void* stream);
int conv_fused_sm90_dual_wgrad_launch(const void* x, const void* g_a,
                                      const void* g_b, float* ws, int splits,
                                      int chunk, int M, int C, int Na,
                                      int Nb, int bn, void* stream);
int conv_fused_sm90_bwd_dgrad_launch(
    const void* g, const void* dzn, const void* yout, const float* gc,
    const void* w, long long s_k, long long s_n, void* gout, const void* x,
    const float* a, const float* b, const void* dsc, const void* p0,
    const void* p1, int n_partners, int mask, void* dz, float* part,
    void* xhat, int M, int K, int N, int bn, void* stream);
int conv_fused_sm90_conv3_launch(const void* x, const float* a,
                                 const float* b, const void* w,
                                 long long s_tap, long long s_c,
                                 long long s_n, void* y, float* stats, int M,
                                 int C, int N, int H, int W, int bn,
                                 void* stream);
int conv_fused_sm90_conv3_bwd_launch(
    const void* dzn, const void* yout, const float* gc, const void* w,
    long long s_tap, long long s_c, long long s_n, void* gout, const void* x,
    const float* a, const float* b, void* dz, float* part, void* xhat,
    float* ws, int splits, int chunk, int M, int C, int N, int H, int W,
    int bn, void* stream);
int conv_fused_sm90_split3_launch(int n, const long long* desc,
                                  void* stream);
int conv_fused_sm90_fwd_x3_launch(const float* x, const float* a,
                                  const float* b, const float* sc,
                                  const float* asc, const float* bsc,
                                  const void* wp, const float* bias,
                                  float* y, float* stats, float* xhat,
                                  int M, int K, int N, void* stream);
int conv_fused_sm90_conv3_x3_launch(const float* x, const float* a,
                                    const float* b, const void* wp, float* y,
                                    float* stats, int M, int C, int N, int H,
                                    int W, void* stream);
int conv_fused_sm90_dual_dgrad_x3_launch(
    const float* dzn_a, const float* yout_a, const float* gc_a,
    const void* wp_a, void* gp_a, const float* dzn_b, const float* yout_b,
    const float* gc_b, const void* wp_b, void* gp_b, float* dx, int M, int C,
    int Na, int Nb, void* stream);
int conv_fused_sm90_bwd_dgrad_x3_launch(
    const float* g, const float* dzn, const float* yout, const float* gc,
    const void* wp, void* gp, const float* x, const float* a,
    const float* b, const float* dsc, const float* p0, const float* p1,
    int n_partners, int mask, float* dz, float* part, void* xhp, int M,
    int K, int N, void* stream);
int conv_fused_sm90_dual_wgrad_x3_launch(const void* xp, const void* gp_a,
                                         const void* gp_b, float* ws,
                                         int splits, int chunk, int M, int C,
                                         int Na, int Nb, void* stream);
int conv_fused_sm90_conv3_bwd_x3_launch(
    const float* dzn, const float* yout, const float* gc, const void* wp,
    void* gp, const float* x, const float* a, const float* b, float* dz,
    float* part, void* xhp, float* ws, int splits, int chunk, int M, int C,
    int N, int H, int W, void* stream);
int lstm_fwd_launch(int in_dtype, int w_dtype, int state_dtype,
                    const void* xp, const void* h, const void* c,
                    const void* w, const void* b, void* h1, void* c1,
                    float* gates, int N, int H, void* stream);
int lstm_fwd_sm90_launch(int in_dtype, int state_dtype, int w_pieces,
                         const void* xp, const void* h, const void* c,
                         const void* wp, const void* b, void* h1, void* c1,
                         float* gates, int N, int H, int Hk, int Hm,
                         void* stream);
int lstm_bwd_launch(int w_dtype, int state_dtype, const float* gates,
                    const void* c, const void* c1, const void* w,
                    const void* dh1, const void* dc1, float* dxp, void* dh,
                    void* dc, int N, int H, void* stream);
int lstm_bwd_sm90_launch(int state_dtype, int w_pieces, const float* gates,
                         const void* c, const void* c1, const void* wp,
                         const void* dh1, const void* dc1, float* dxp,
                         void* dh, void* dc, void* dzs, int N, int H, int Hk,
                         int Hm, void* stream);
int multibox_match_launch(const float* anchors, const float* labels, int B,
                          int N, int M, float thr, float v0, float v1,
                          float v2, float v3, int anchors_in_smem,
                          int* scratch, int* agt, float* aiou, float* loc,
                          void* stream);
int nms_keep_launch(const float* boxes, const float* ids,
                    const unsigned char* valid, int B, int k, float thr,
                    int force, int mask_in_smem, unsigned long long* mask,
                    unsigned char* keep, void* stream);
int multibox_match_cluster_launch(const float* anchors, const float* labels,
                                  int B, int N, int M, int split, int mode,
                                  float thr, float v0, float v1, float v2,
                                  float v3, int* scratch, int* agt,
                                  float* aiou, float* loc, void* stream);
int nms_keep_cluster_launch(const float* boxes, const float* ids,
                            const unsigned char* valid, long long sb,
                            long long si, long long sv, int B, int k,
                            int split, int mode, float thr, int force,
                            unsigned long long* gmask, unsigned char* keep,
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

// The decode kernels' split route (both layouts): q (S, H, d); k/v
// (S, H, page_len, d) with n_pages 1 (contiguous; page_len is the cache
// length) or (n_pool, H, page_len, d) with block_tables (S, n_pages)
// int32 (paged); lengths (S,) int32; ws (S * H, n_split, d + 2) float32
// or null when n_split is 1; tickets (S * H,) int32 zeros or null.
int mxt_decode_split(int paged, int dtype, const void* q, const void* k,
                     const void* v, void* out, const void* lengths,
                     const void* block_tables, void* ws, void* tickets, int S,
                     int H, int d, int page_len, int n_pages, int n_pool,
                     int tile_rows, int tiles_per_split, int n_split,
                     float scale, void* stream) {
  return decode_split_launch(
      paged, dtype, q, k, v, out, static_cast<const int*>(lengths),
      static_cast<const int*>(block_tables), static_cast<float*>(ws),
      static_cast<int*>(tickets), S, H, d, page_len, n_pages, n_pool,
      tile_rows, tiles_per_split, n_split, scale, stream);
}

// Training attention. layout 0: q/k/v (B, T, H*d), lse/delta (B, T, H)
// float32; layout 1: q/k/v (B, H, T, d), lse/delta (B, H, T). k/v have
// sk rows, q/dout sq rows. Outputs have their input's layout and type.
// fma 1 takes the float32 FMA kernels instead of the split-bf16 mma.sync
// ones (float32 only).
int mxt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int H, int sq, int sk, int d, int layout,
                  int causal, int dtype, int fma, float scale, void* stream) {
  return flash_attention_launch(0, layout, dtype, fma, q, k, v, nullptr,
                                nullptr, nullptr, out, nullptr,
                                static_cast<float*>(lse), B, H, sq, sk, d,
                                causal, scale, stream);
}

// The bf16 forward's Hopper route (flash_attention_sm90.cu): TMA-fed
// wgmma, same layouts and outputs as mxt_flash_fwd.
int mxt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int H, int sq, int sk,
                       int d, int layout, int causal, float scale,
                       void* stream) {
  return flash_fwd_sm90_launch(layout, q, k, v, out,
                               static_cast<float*>(lse), B, H, sq, sk, d,
                               causal, scale, stream);
}

int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int sq, int sk, int d,
                     int layout, int causal, int dtype, int fma, float scale,
                     void* stream) {
  return flash_attention_launch(1, layout, dtype, fma, q, k, v, dout,
                                static_cast<const float*>(lse),
                                static_cast<const float*>(delta), dq,
                                nullptr, nullptr, B, H, sq, sk, d, causal,
                                scale, stream);
}

int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int sq, int sk,
                      int d, int layout, int causal, int dtype, int fma,
                      float scale, void* stream) {
  return flash_attention_launch(2, layout, dtype, fma, q, k, v, dout,
                                static_cast<const float*>(lse),
                                static_cast<const float*>(delta), dk, dv,
                                nullptr, B, H, sq, sk, d, causal, scale,
                                stream);
}

// The bf16 backward's Hopper route (flash_attention_sm90.cu): TMA-fed
// wgmma, same layouts and outputs as mxt_flash_bwd_dq / mxt_flash_bwd_dkv.
int mxt_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int B, int H, int sq,
                          int sk, int d, int layout, int causal, float scale,
                          void* stream) {
  return flash_bwd_sm90_launch(0, layout, q, k, v, dout,
                               static_cast<const float*>(lse),
                               static_cast<const float*>(delta), dq, nullptr,
                               B, H, sq, sk, d, causal, scale, stream);
}

int mxt_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int H, int sq, int sk, int d, int layout,
                           int causal, float scale, void* stream) {
  return flash_bwd_sm90_launch(1, layout, q, k, v, dout,
                               static_cast<const float*>(lse),
                               static_cast<const float*>(delta), dk, dv, B,
                               H, sq, sk, d, causal, scale, stream);
}

// Layer norm over the last axis of x (n, d); gamma/beta (d,) float32;
// y like x; mu/rstd (n,) float32.
int mxt_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                       void* y, void* mu, void* rstd, int n, int d, int dtype,
                       float eps, void* stream) {
  return layer_norm_fwd_launch(dtype, x, static_cast<const float*>(gamma),
                               static_cast<const float*>(beta), y,
                               static_cast<float*>(mu),
                               static_cast<float*>(rstd), n, d, eps, stream);
}

// The vector forward (d <= 1024): y like x; mu/rstd (n,) float32; block b
// owns rows [b rows_per_block, ...).
int mxt_layer_norm_fwd_vec(const void* x, const void* gamma,
                           const void* beta, void* y, void* mu, void* rstd,
                           int n, int d, int rows_per_block, int blocks,
                           int dtype, float eps, void* stream) {
  return layer_norm_fwd_vec_launch(
      dtype, x, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), y, static_cast<float*>(mu),
      static_cast<float*>(rstd), n, d, eps, rows_per_block, blocks, stream);
}

// dx like x; dg/db (ceil(n / rows_per_block), d) float32 column partials
// of dy * xn and dy.
int mxt_layer_norm_bwd(const void* x, const void* gamma, const void* mu,
                       const void* rstd, const void* dy, void* dx, void* dg,
                       void* db, int n, int d, int rows_per_block, int dtype,
                       void* stream) {
  return layer_norm_bwd_launch(
      dtype, x, static_cast<const float*>(gamma),
      static_cast<const float*>(mu), static_cast<const float*>(rstd), dy, dx,
      static_cast<float*>(dg), static_cast<float*>(db), n, d, rows_per_block,
      stream);
}

// The one-pass backward (d <= 1024): dx like x; dgamma/dbeta (d,) float32
// sums; ws (blocks + groups, 2, d) float32 scratch and tickets (groups +
// 1,) int32 zeros, groups = ceil(blocks / 16).
int mxt_layer_norm_bwd_onepass(const void* x, const void* gamma,
                               const void* mu, const void* rstd,
                               const void* dy, void* dx, void* dgamma,
                               void* dbeta, void* ws, void* tickets, int n,
                               int d, int rows_per_block, int blocks,
                               int dtype, void* stream) {
  return layer_norm_bwd_onepass_launch(
      dtype, x, static_cast<const float*>(gamma),
      static_cast<const float*>(mu), static_cast<const float*>(rstd), dy, dx,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<float*>(ws), static_cast<int*>(tickets), n, d,
      rows_per_block, blocks, stream);
}

// Softmax over the last axis of x (n, d); y like x.
int mxt_softmax_fwd(const void* x, void* y, int n, int d, int dtype,
                    void* stream) {
  return softmax_fwd_launch(dtype, x, y, n, d, stream);
}

// Fused conv + BN + ReLU (conv_fused.cu). Activations are NHWC rows
// (M, C); w is read at w[tap * s_tap + c * s_c + n * s_n]; per-channel
// vectors and gc (3, N) are float32; null pointers switch options off.
int mxt_conv_fused_fwd(int dtype, int ks, const void* x, const void* a,
                       const void* b, const void* sc, const void* asc,
                       const void* bsc, const void* w, long long s_tap,
                       long long s_c, long long s_n, const void* bias,
                       void* y, void* stats, void* xhat, int M, int C, int N,
                       int H, int W, void* stream) {
  return conv_fused_fwd_launch(
      dtype, ks, x, static_cast<const float*>(a),
      static_cast<const float*>(b), sc, static_cast<const float*>(asc),
      static_cast<const float*>(bsc), w, s_tap, s_c, s_n,
      static_cast<const float*>(bias), y, static_cast<float*>(stats), xhat,
      M, C, N, H, W, stream);
}

int mxt_conv_fused_dgrad(int dtype, int ks, const void* g, const void* dzn,
                         const void* yout, const void* gc, const void* w,
                         long long s_tap, long long s_c, long long s_n,
                         const void* x, const void* a, const void* b,
                         const void* dsc, const void* p0, const void* p1,
                         int n_partners, int mask, void* dz, void* part,
                         int M, int C, int N, int H, int W, void* stream) {
  return conv_fused_dgrad_launch(
      dtype, ks, g, dzn, yout, static_cast<const float*>(gc), w, s_tap, s_c,
      s_n, x, static_cast<const float*>(a), static_cast<const float*>(b),
      dsc, p0, p1, n_partners, mask, dz, static_cast<float*>(part), M, C, N,
      H, W, stream);
}

int mxt_conv_fused_wgrad(int dtype, int ks, const void* x, const void* a,
                         const void* b, const void* g, const void* dzn,
                         const void* yout, const void* gc, void* ws,
                         int splits, int chunk, int M, int C, int N, int H,
                         int W, void* stream) {
  return conv_fused_wgrad_launch(
      dtype, ks, x, static_cast<const float*>(a),
      static_cast<const float*>(b), g, dzn, yout,
      static_cast<const float*>(gc), static_cast<float*>(ws), splits, chunk,
      M, C, N, H, W, stream);
}

// The dual 1x1 dgrad of a junction feeding two convs: dx = G_a w_a^T +
// G_b w_b^T, each G = (dzn g0 - g1) - yout g2 with gc (3, N) float32.
int mxt_conv_fused_dual_dgrad(int dtype, const void* dzn_a,
                              const void* yout_a, const void* gc_a,
                              const void* w_a, long long s_c_a,
                              long long s_n_a, const void* dzn_b,
                              const void* yout_b, const void* gc_b,
                              const void* w_b, long long s_c_b,
                              long long s_n_b, void* dx, int M, int C,
                              int Na, int Nb, void* stream) {
  return conv_fused_dual_dgrad_launch(
      dtype, dzn_a, yout_a, static_cast<const float*>(gc_a), w_a, s_c_a,
      s_n_a, dzn_b, yout_b, static_cast<const float*>(gc_b), w_b, s_c_b,
      s_n_b, dx, M, C, Na, Nb, stream);
}

// ws (splits, Na + Nb, C) float32 partials of both dW, gluon order.
int mxt_conv_fused_dual_wgrad(int dtype, const void* x, const void* dzn_a,
                              const void* yout_a, const void* gc_a,
                              const void* dzn_b, const void* yout_b,
                              const void* gc_b, void* ws, int splits,
                              int chunk, int M, int C, int Na, int Nb,
                              void* stream) {
  return conv_fused_dual_wgrad_launch(
      dtype, x, dzn_a, yout_a, static_cast<const float*>(gc_a), dzn_b,
      yout_b, static_cast<const float*>(gc_b), static_cast<float*>(ws),
      splits, chunk, M, C, Na, Nb, stream);
}

// The bf16 route of mm_fused and dgrad_epilogue (conv_fused_sm90.cu):
// TMA-fed wgmma; bn (64, 128 or 256) is the tile width the wrapper plans.
int mxt_conv_fused_sm90_fwd(const void* x, const void* a, const void* b,
                            const void* sc, const void* asc, const void* bsc,
                            const void* w, long long s_k, long long s_n,
                            const void* bias, void* y, void* stats,
                            void* xhat, int M, int K, int N, int bn,
                            void* stream) {
  return conv_fused_sm90_fwd_launch(
      x, static_cast<const float*>(a), static_cast<const float*>(b), sc,
      static_cast<const float*>(asc), static_cast<const float*>(bsc), w, s_k,
      s_n, static_cast<const float*>(bias), y, static_cast<float*>(stats),
      xhat, M, K, N, bn, stream);
}

int mxt_conv_fused_sm90_dual_dgrad(const void* dzn_a, const void* yout_a,
                                   const void* gc_a, const void* w_a,
                                   long long s_c_a, long long s_n_a,
                                   void* g_a, const void* dzn_b,
                                   const void* yout_b, const void* gc_b,
                                   const void* w_b, long long s_c_b,
                                   long long s_n_b, void* g_b, void* dx,
                                   int M, int C, int Na, int Nb, int bn,
                                   void* stream) {
  return conv_fused_sm90_dual_dgrad_launch(
      dzn_a, yout_a, static_cast<const float*>(gc_a), w_a, s_c_a, s_n_a, g_a,
      dzn_b, yout_b, static_cast<const float*>(gc_b), w_b, s_c_b, s_n_b, g_b,
      dx, M, C, Na, Nb, bn, stream);
}

// dW partials from the G the dgrad wrote: ws (splits, Na + Nb, C) float32.
int mxt_conv_fused_sm90_dual_wgrad(const void* x, const void* g_a,
                                   const void* g_b, void* ws, int splits,
                                   int chunk, int M, int C, int Na, int Nb,
                                   int bn, void* stream) {
  return conv_fused_sm90_dual_wgrad_launch(x, g_a, g_b,
                                           static_cast<float*>(ws), splits,
                                           chunk, M, C, Na, Nb, bn, stream);
}

// The bf16 route of mm_fused_bwd's dgrad (its wgrad is the single-set
// call above, Nb = 0): dz, the (blocks, 1 + n_partners, K) partials, the
// bf16 G (gout) when it is formed on load, x^ when a is passed.
int mxt_conv_fused_sm90_bwd_dgrad(const void* g, const void* dzn,
                                  const void* yout, const void* gc,
                                  const void* w, long long s_k,
                                  long long s_n, void* gout, const void* x,
                                  const void* a, const void* b,
                                  const void* dsc, const void* p0,
                                  const void* p1, int n_partners, int mask,
                                  void* dz, void* part, void* xhat, int M,
                                  int K, int N, int bn, void* stream) {
  return conv_fused_sm90_bwd_dgrad_launch(
      g, dzn, yout, static_cast<const float*>(gc), w, s_k, s_n, gout, x,
      static_cast<const float*>(a), static_cast<const float*>(b), dsc, p0,
      p1, n_partners, mask, dz, static_cast<float*>(part), xhat, M, K, N,
      bn, stream);
}

// The bf16 route of conv3_fused: y and the (blocks, 2, N) stats partials.
int mxt_conv_fused_sm90_conv3(const void* x, const void* a, const void* b,
                              const void* w, long long s_tap, long long s_c,
                              long long s_n, void* y, void* stats, int M,
                              int C, int N, int H, int W, int bn,
                              void* stream) {
  return conv_fused_sm90_conv3_launch(
      x, static_cast<const float*>(a), static_cast<const float*>(b), w,
      s_tap, s_c, s_n, y, static_cast<float*>(stats), M, C, N, H, W, bn,
      stream);
}

// The bf16 route of conv3_fused_bwd: the dgrad (dz, the (blocks, 2, C)
// partials, G to gout and x^ to xhat), then the wgrad's (splits, N, 9 C)
// dW partials in ws.
int mxt_conv_fused_sm90_conv3_bwd(const void* dzn, const void* yout,
                                  const void* gc, const void* w,
                                  long long s_tap, long long s_c,
                                  long long s_n, void* gout, const void* x,
                                  const void* a, const void* b, void* dz,
                                  void* part, void* xhat, void* ws,
                                  int splits, int chunk, int M, int C, int N,
                                  int H, int W, int bn, void* stream) {
  return conv_fused_sm90_conv3_bwd_launch(
      dzn, yout, static_cast<const float*>(gc), w, s_tap, s_c, s_n, gout, x,
      static_cast<const float*>(a), static_cast<const float*>(b), dz,
      static_cast<float*>(part), xhat, static_cast<float*>(ws), splits,
      chunk, M, C, N, H, W, bn, stream);
}

// The float32 route of the fused convs (conv_fused_sm90.cu, every
// operand in three bf16 pieces): the piece planes of n (1-3) strided
// float32 operands in one launch, desc n records {src, s_i, s_j, R, O,
// dst}, dst (3, R, O)
int mxt_conv_fused_sm90_split3(int n, const void* desc, void* stream) {
  return conv_fused_sm90_split3_launch(
      n, static_cast<const long long*>(desc), stream);
}

// y (M, N) float32 (+ bias), the (blocks, 2, N) stats partials and x^
// (M, K) (each if passed) from x, sc and W's pieces wp (3, K, N)
int mxt_conv_fused_sm90_fwd_x3(const void* x, const void* a, const void* b,
                               const void* sc, const void* asc,
                               const void* bsc, const void* wp,
                               const void* bias, void* y, void* stats,
                               void* xhat, int M, int K, int N,
                               void* stream) {
  return conv_fused_sm90_fwd_x3_launch(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(sc),
      static_cast<const float*>(asc), static_cast<const float*>(bsc), wp,
      static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<float*>(stats), static_cast<float*>(xhat), M, K, N,
      stream);
}

// y (M, N) float32 and the (blocks, 2, N) stats partials from x and W9's
// pieces wp (3, 9 C, N)
int mxt_conv_fused_sm90_conv3_x3(const void* x, const void* a, const void* b,
                                 const void* wp, void* y, void* stats, int M,
                                 int C, int N, int H, int W, void* stream) {
  return conv_fused_sm90_conv3_x3_launch(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), wp, static_cast<float*>(y),
      static_cast<float*>(stats), M, C, N, H, W, stream);
}

// dx (M, C) float32 from both sets (W_set^T's pieces (3, N_set, C)), G's
// pieces (3, M, N_set) written for the wgrad
int mxt_conv_fused_sm90_dual_dgrad_x3(const void* dzn_a, const void* yout_a,
                                      const void* gc_a, const void* wp_a,
                                      void* gp_a, const void* dzn_b,
                                      const void* yout_b, const void* gc_b,
                                      const void* wp_b, void* gp_b, void* dx,
                                      int M, int C, int Na, int Nb,
                                      void* stream) {
  return conv_fused_sm90_dual_dgrad_x3_launch(
      static_cast<const float*>(dzn_a), static_cast<const float*>(yout_a),
      static_cast<const float*>(gc_a), wp_a, gp_a,
      static_cast<const float*>(dzn_b), static_cast<const float*>(yout_b),
      static_cast<const float*>(gc_b), wp_b, gp_b, static_cast<float*>(dx),
      M, C, Na, Nb, stream);
}

// The float32 route of mm_fused_bwd's dgrad: dz (M, K) float32, the
// (blocks, 1 + n_partners, K) partials, G's pieces gp (3, M, N) and, when
// a is passed, x^'s pieces xhp (3, M, K) for the wgrad (the single-set
// call below, Nb = 0); wp (3, N, K) the pieces of W^T
int mxt_conv_fused_sm90_bwd_dgrad_x3(const void* g, const void* dzn,
                                     const void* yout, const void* gc,
                                     const void* wp, void* gp, const void* x,
                                     const void* a, const void* b,
                                     const void* dsc, const void* p0,
                                     const void* p1, int n_partners,
                                     int mask, void* dz, void* part,
                                     void* xhp, int M, int K, int N,
                                     void* stream) {
  return conv_fused_sm90_bwd_dgrad_x3_launch(
      static_cast<const float*>(g), static_cast<const float*>(dzn),
      static_cast<const float*>(yout), static_cast<const float*>(gc), wp, gp,
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(dsc),
      static_cast<const float*>(p0), static_cast<const float*>(p1),
      n_partners, mask, static_cast<float*>(dz), static_cast<float*>(part),
      xhp, M, K, N, stream);
}

// the (splits, Na + Nb, C) dW partials from x's and G's pieces (Nb = 0 and
// gp_b null: one set)
int mxt_conv_fused_sm90_dual_wgrad_x3(const void* xp, const void* gp_a,
                                      const void* gp_b, void* ws, int splits,
                                      int chunk, int M, int C, int Na, int Nb,
                                      void* stream) {
  return conv_fused_sm90_dual_wgrad_x3_launch(
      xp, gp_a, gp_b, static_cast<float*>(ws), splits, chunk, M, C, Na, Nb,
      stream);
}

// The float32 route of conv3_fused_bwd: the dgrad (dz (M, C) float32, the
// (blocks, 2, C) partials, G's pieces to gp (3, M, N) and x^'s to xhp
// (3, M, C)) from wp (3, N, 9 C), the pieces of W9^T; then the wgrad's
// (splits, N, 9 C) dW partials in ws
int mxt_conv_fused_sm90_conv3_bwd_x3(const void* dzn, const void* yout,
                                     const void* gc, const void* wp,
                                     void* gp, const void* x, const void* a,
                                     const void* b, void* dz, void* part,
                                     void* xhp, void* ws, int splits,
                                     int chunk, int M, int C, int N, int H,
                                     int W, void* stream) {
  return conv_fused_sm90_conv3_bwd_x3_launch(
      static_cast<const float*>(dzn), static_cast<const float*>(yout),
      static_cast<const float*>(gc), wp, gp, static_cast<const float*>(x),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(dz), static_cast<float*>(part), xhp,
      static_cast<float*>(ws), splits, chunk, M, C, N, H, W, stream);
}

// One LSTM step (lstm.cu), the FMA kernel: xp (N, 4H) and b (4H,) of type
// in_dtype, w (4H, H) of type w_dtype; h, c, h1, c1 (N, H) of type
// state_dtype; gates (N, 4H) float32, or null for the variant without the
// residual.
int mxt_lstm_fwd(int in_dtype, int w_dtype, int state_dtype, const void* xp,
                 const void* h, const void* c, const void* w, const void* b,
                 void* h1, void* c1, void* gates, int N, int H,
                 void* stream) {
  return lstm_fwd_launch(in_dtype, w_dtype, state_dtype, xp, h, c, w, b, h1,
                         c1, static_cast<float*>(gates), N, H, stream);
}

// Its tensor-core form (lstm.cu): wp W's zero-padded (w_pieces, 4, Hk, Hm)
// bf16 copy, one piece for a bf16 W, three (hi, mid, lo) for a float32 W.
int mxt_lstm_fwd_sm90(int in_dtype, int state_dtype, int w_pieces,
                      const void* xp, const void* h, const void* c,
                      const void* wp, const void* b, void* h1, void* c1,
                      void* gates, int N, int H, int Hk, int Hm,
                      void* stream) {
  return lstm_fwd_sm90_launch(in_dtype, state_dtype, w_pieces, xp, h, c, wp,
                              b, h1, c1, static_cast<float*>(gates), N, H,
                              Hk, Hm, stream);
}

// Its backward: gates and dxp (N, 4H) float32; w of type w_dtype; c, c1,
// dh1, dc1, dh, dc (N, H) of type state_dtype.
int mxt_lstm_bwd(int w_dtype, int state_dtype, const void* gates,
                 const void* c, const void* c1, const void* w,
                 const void* dh1, const void* dc1, void* dxp, void* dh,
                 void* dc, int N, int H, void* stream) {
  return lstm_bwd_launch(w_dtype, state_dtype,
                         static_cast<const float*>(gates), c, c1, w, dh1,
                         dc1, static_cast<float*>(dxp), dh, dc, N, H,
                         stream);
}

// Its tensor-core form (lstm.cu): wp W's zero-padded (w_pieces, 4, Hk, Hm)
// bf16 copy, one piece for a bf16 W, three (hi, mid, lo) for a float32 W;
// dzs a (3, N, 4, Hk) bf16 scratch for dz's pieces.
int mxt_lstm_bwd_sm90(int state_dtype, int w_pieces, const void* gates,
                      const void* c, const void* c1, const void* wp,
                      const void* dh1, const void* dc1, void* dxp, void* dh,
                      void* dc, void* dzs, int N, int H, int Hk, int Hm,
                      void* stream) {
  return lstm_bwd_sm90_launch(state_dtype, w_pieces,
                              static_cast<const float*>(gates), c, c1, wp,
                              dh1, dc1, static_cast<float*>(dxp), dh, dc,
                              dzs, N, H, Hk, Hm, stream);
}

// The SSD matcher (detection.cu): anchors (N, 4) and labels (B, M, 5)
// float32; agt (B, N) int32, aiou (B, N) and loc (B, N, 4) float32;
// scratch (B, 3M) int32 for the label state, or null to keep it in shared
// memory.
int mxt_multibox_match(const void* anchors, const void* labels, int B, int N,
                       int M, float thr, float v0, float v1, float v2,
                       float v3, int anchors_in_smem, void* scratch,
                       void* agt, void* aiou, void* loc, void* stream) {
  return multibox_match_launch(
      static_cast<const float*>(anchors), static_cast<const float*>(labels),
      B, N, M, thr, v0, v1, v2, v3, anchors_in_smem,
      static_cast<int*>(scratch), static_cast<int*>(agt),
      static_cast<float*>(aiou), static_cast<float*>(loc), stream);
}

// Greedy NMS (detection.cu): boxes (B, k, 4) and ids (B, k) float32, valid
// and keep (B, k) bytes; mask (B, k, ceil(k / 64)) 64-bit words of scratch,
// which the sweep copies into shared memory when mask_in_smem.
int mxt_nms_keep(const void* boxes, const void* ids, const void* valid,
                 int B, int k, float thr, int force, int mask_in_smem,
                 void* mask, void* keep, void* stream) {
  return nms_keep_launch(static_cast<const float*>(boxes),
                         static_cast<const float*>(ids),
                         static_cast<const unsigned char*>(valid), B, k, thr,
                         force, mask_in_smem,
                         static_cast<unsigned long long*>(mask),
                         static_cast<unsigned char*>(keep), stream);
}

// The cluster matcher (detection.cu): as mxt_multibox_match, one image a
// cluster of `split` blocks; mode 2 keeps the IoU slice in shared memory,
// 1 recomputes it, 0 keeps the label state in scratch (B split, 10 M)
// int32.
int mxt_multibox_match_cluster(const void* anchors, const void* labels,
                               int B, int N, int M, int split, int mode,
                               float thr, float v0, float v1, float v2,
                               float v3, void* scratch, void* agt,
                               void* aiou, void* loc, void* stream) {
  return multibox_match_cluster_launch(
      static_cast<const float*>(anchors), static_cast<const float*>(labels),
      B, N, M, split, mode, thr, v0, v1, v2, v3, static_cast<int*>(scratch),
      static_cast<int*>(agt), static_cast<float*>(aiou),
      static_cast<float*>(loc), stream);
}

// The cluster NMS (detection.cu): boxes, ids and valid of image b at b
// times the batch strides sb, si, sv (elements); keep (B, k) bytes; gmask
// (B, k, ceil(k / 64)) words in modes 0 and 1, else null.
int mxt_nms_keep_cluster(const void* boxes, const void* ids,
                         const void* valid, long long sb, long long si,
                         long long sv, int B, int k, int split, int mode,
                         float thr, int force, void* gmask, void* keep,
                         void* stream) {
  return nms_keep_cluster_launch(
      static_cast<const float*>(boxes), static_cast<const float*>(ids),
      static_cast<const unsigned char*>(valid), sb, si, sv, B, k, split,
      mode, thr, force, static_cast<unsigned long long*>(gmask),
      static_cast<unsigned char*>(keep), stream);
}

const char* mxt_cuda_error_string(int code) {
  return decode_attention_error_string(code);
}

}  // extern "C"
