// K19: TPC-C query generation, one epoch of Payment + NewOrder queries.
//
// Replaces deneva_tpu/workloads/tpcc.py:470 TPCCWorkload.generate with
// :174 _nurand, on the reference's threefry stream bit for bit:
// split(rng, 12) -> ks; is_pay = bernoulli(ks0, perc_payment); w, d =
// randint(ks1, ks2); the remote payment customer (bernoulli 0.15 from ks3,
// w' from ks4 skipping w, d' from ks5); by_last = bernoulli(ks6, 0.6);
// lastname = NURand(255) from ks7; c_direct = NURand(1023) from ks8;
// h_amount = uniform(ks9, 1, 5000); ol_cnt = randint(ks10, 5, I + 1);
// split(ks11, 4) -> ki, kq, kr, kw: items = NURand(8191) from ki,
// quantity = randint(kq, 1, 11), the remote supply warehouse (bernoulli
// 0.01 per item from kr's first key, bernoulli mpr_neworder per txn from
// its second, w' from kw), and the in-txn dedup: a lane within ol_cnt is
// valid iff no earlier lane holds its item (jnp.argmax's first
// occurrence).  randint is jax's (two draws folded by remainders in
// wrapping uint32, the multiplier wrapping to 0 above span 2^16:
// max_items = 100000 takes that branch); NURand(A, n) = (randint(0, A+1)
// | randint(0, n)) % n on the two keys of split(key).
//   h_amount: XLA computes f * 4999 + 1 as one FMA, so __fmaf_rn, then
//   max(1, .); nothing else here is a float expression.
//   The by-last-name customer: with the CUSTOMER_LAST index the kernel
//   writes the probe key (c_w * 10 + c_d) * names + lastname and the
//   flag by_last & is_pay, and c_id = c_direct; the probe is K14a and
//   the postings gather plus the select are glue.  Without the index it
//   writes the closed-form middle customer.
// Design: a block of 256 threads holds 256 / I_pad whole txns (I_pad the
// power of two >= max_items_per_txn <= 32), one thread per (txn, item
// lane).  The block first derives the 50 keys of the split tree into
// shared memory, one level per pass; then lane 0 of each txn draws the
// per-txn fields, every lane draws its item, quantity and supply
// warehouse, and after a barrier each lane checks the earlier lanes of
// its txn for its item.
//   Bound: operations — 23 threefry hashes per txn and 9 per item
//   lane against 53 output bytes per txn at I = 15.
#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxItems = 32;

// the split tree: key e = split(key kSrc[e], kCtr[e])[kCtr[e]], kSrc -1
// the root; levels [0, 12), [12, 30), [30, 46), [46, 50)
enum Key {
  KS0, KS1, KS2, KS3, KS4, KS5, KS6, KS7, KS8, KS9, KS10, KS11,
  W_HI, W_LO, D_HI, D_LO, RW_HI, RW_LO, CD_HI, CD_LO,
  LA, LB, CA, CB, OL_HI, OL_LO, KI, KQ, KR, KW,
  LA_HI, LA_LO, LB_HI, LB_LO, CA_HI, CA_LO, CB_HI, CB_LO,
  KIA, KIB, Q_HI, Q_LO, KR1, KR2, WS_HI, WS_LO,
  KIA_HI, KIA_LO, KIB_HI, KIB_LO,
  kNumKeys
};

__constant__ int kSrc[kNumKeys] = {
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    KS1, KS1, KS2, KS2, KS4, KS4, KS5, KS5,
    KS7, KS7, KS8, KS8, KS10, KS10, KS11, KS11, KS11, KS11,
    LA, LA, LB, LB, CA, CA, CB, CB,
    KI, KI, KQ, KQ, KR, KR, KW, KW,
    KIA, KIA, KIB, KIB};
__constant__ int kCtr[kNumKeys] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
    0, 1, 0, 1, 0, 1, 0, 1,
    0, 1, 0, 1, 0, 1, 0, 1, 2, 3,
    0, 1, 0, 1, 0, 1, 0, 1,
    0, 1, 0, 1, 0, 1, 0, 1,
    0, 1, 0, 1};
__constant__ int kLevel[5] = {0, 12, 30, 46, kNumKeys};

__device__ __forceinline__ bool bernoulli_at(const uint32_t* sk, int key,
                                             uint64_t idx, float p) {
  return dt_bits_to_uniform(dt_random_bits(sk[2 * key], sk[2 * key + 1],
                                           idx)) < p;
}

__device__ __forceinline__ int32_t randint_keys(const uint32_t* sk, int hi_key,
                                                int lo_key, uint64_t idx,
                                                int32_t lo, int32_t hi) {
  return dt_randint_at(sk + 2 * hi_key, sk + 2 * lo_key, idx, lo, hi);
}

// NURand(a, 0, n - 1) with C = 0 from the four keys of its split tree
__device__ __forceinline__ int32_t nurand_at(const uint32_t* sk, int a_hi,
                                             int a_lo, int b_hi, int b_lo,
                                             uint64_t idx, int a, int n) {
  const int32_t x = randint_keys(sk, a_hi, a_lo, idx, 0, a + 1);
  const int32_t y = randint_keys(sk, b_hi, b_lo, idx, 0, n);
  return (x | y) % n;
}

__global__ void tpcc_generate_kernel(
    const int64_t* __restrict__ rng, int n, int ipt, int ipad, int n_wh,
    int cust_per_dist, int names, int max_items, float p_pay, float p_mpr,
    int by_last_index, int32_t* __restrict__ txn_type,
    int32_t* __restrict__ w_id, int32_t* __restrict__ d_id,
    int32_t* __restrict__ c_id, int32_t* __restrict__ c_w_id,
    int32_t* __restrict__ c_d_id, float* __restrict__ h_amount,
    int32_t* __restrict__ ol_cnt, int32_t* __restrict__ items,
    uint8_t* __restrict__ item_valid, int32_t* __restrict__ supply_w,
    int32_t* __restrict__ quantity, int32_t* __restrict__ probe,
    uint8_t* __restrict__ use_mid) {
  __shared__ uint32_t sk[2 * kNumKeys];
  __shared__ int32_t s_w[kThreads], s_ol[kThreads], s_item[kThreads];
  __shared__ uint8_t s_mpr[kThreads];
  for (int lv = 0; lv < 4; ++lv) {
    const int e = kLevel[lv] + static_cast<int>(threadIdx.x);
    if (e < kLevel[lv + 1]) {
      const int src = kSrc[e];
      const uint32_t k0 = src < 0 ? static_cast<uint32_t>(rng[0])
                                  : sk[2 * src];
      const uint32_t k1 = src < 0 ? static_cast<uint32_t>(rng[1])
                                  : sk[2 * src + 1];
      dt_split_key(k0, k1, static_cast<uint32_t>(kCtr[e]), sk + 2 * e);
    }
    __syncthreads();
  }
  const int per_block = kThreads / ipad;
  const int lt = static_cast<int>(threadIdx.x) / ipad;
  const int lane = static_cast<int>(threadIdx.x) % ipad;
  const int t = blockIdx.x * per_block + lt;
  const bool live = t < n && lt < per_block;
  const int span_w = n_wh - 1 > 1 ? n_wh - 1 : 1;
  if (live && lane == 0) {
    const uint64_t i = static_cast<uint64_t>(t);
    const bool is_pay = bernoulli_at(sk, KS0, i, p_pay);
    const int32_t w = randint_keys(sk, W_HI, W_LO, i, 0, n_wh);
    const int32_t d = randint_keys(sk, D_HI, D_LO, i, 0, 10);
    const bool remote = bernoulli_at(sk, KS3, i, 0.15f) && n_wh > 1;
    int32_t rw = randint_keys(sk, RW_HI, RW_LO, i, 0, span_w);
    rw = rw >= w ? rw + 1 : rw;
    const int32_t cw = remote ? rw : w;
    const int32_t cd = remote ? randint_keys(sk, CD_HI, CD_LO, i, 0, 10) : d;
    const bool by_last = bernoulli_at(sk, KS6, i, 0.6f);
    const int32_t lastname =
        nurand_at(sk, LA_HI, LA_LO, LB_HI, LB_LO, i, 255, names);
    const int32_t direct = nurand_at(sk, CA_HI, CA_LO, CB_HI, CB_LO, i, 1023,
                                     cust_per_dist);
    const bool mid = by_last && is_pay;
    if (by_last_index) {
      c_id[t] = direct;
      probe[t] = (cw * 10 + cd) * names + lastname;
      use_mid[t] = mid;
    } else {
      const int32_t per_name = cust_per_dist / names;
      c_id[t] = mid ? lastname + names * (per_name / 2) : direct;
      probe[t] = 0;
      use_mid[t] = 0;
    }
    const float f = dt_bits_to_uniform(
        dt_random_bits(sk[2 * KS9], sk[2 * KS9 + 1], i));
    h_amount[t] = fmaxf(1.0f, __fmaf_rn(f, 4999.0f, 1.0f));
    const int32_t ol = randint_keys(sk, OL_HI, OL_LO, i, 5, ipt + 1);
    txn_type[t] = is_pay ? 0 : 1;
    w_id[t] = w;
    d_id[t] = d;
    c_w_id[t] = cw;
    c_d_id[t] = cd;
    ol_cnt[t] = ol;
    s_w[lt] = w;
    s_ol[lt] = ol;
    s_mpr[lt] = bernoulli_at(sk, KR2, i, p_mpr) ? 1 : 0;
  }
  __syncthreads();
  int32_t item = 0;
  const bool item_lane = live && lane < ipt;
  if (item_lane) {
    const uint64_t idx = static_cast<uint64_t>(t) * ipt + lane;
    item = nurand_at(sk, KIA_HI, KIA_LO, KIB_HI, KIB_LO, idx, 8191,
                     max_items);
    s_item[threadIdx.x] = item;
    const int32_t w = s_w[lt];
    int32_t rs = randint_keys(sk, WS_HI, WS_LO, idx, 0, span_w);
    rs = rs >= w ? rs + 1 : rs;
    const bool rem =
        bernoulli_at(sk, KR1, idx, 0.01f) && s_mpr[lt] && n_wh > 1;
    items[idx] = item;
    quantity[idx] = randint_keys(sk, Q_HI, Q_LO, idx, 1, 11);
    supply_w[idx] = rem ? rs : w;
  }
  __syncthreads();
  if (item_lane) {
    bool first = true;
    const int row = lt * ipad;
    for (int j = 0; j < lane; ++j) first = first && s_item[row + j] != item;
    item_valid[static_cast<uint64_t>(t) * ipt + lane] =
        (lane < s_ol[lt] && first) ? 1 : 0;
  }
}

}  // namespace

// K19: n TPC-C queries (ipt = max_items_per_txn <= 32 item lanes) from
// the raw threefry key rng int64[2]; per-item outputs are [n, ipt].
DT_EXPORT int dt_tpcc_generate(
    const int64_t* rng, int n, int ipt, int n_wh, int cust_per_dist,
    int names, int max_items, float p_pay, float p_mpr, int by_last_index,
    int32_t* txn_type, int32_t* w_id, int32_t* d_id, int32_t* c_id,
    int32_t* c_w_id, int32_t* c_d_id, float* h_amount, int32_t* ol_cnt,
    int32_t* items, uint8_t* item_valid, int32_t* supply_w,
    int32_t* quantity, int32_t* probe, uint8_t* use_mid, void* stream) {
  if (ipt < 1 || ipt > kMaxItems || n_wh < 1 || names < 1 ||
      max_items < 1 || cust_per_dist < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return dt_status();
  int ipad = 1;
  while (ipad < ipt) ipad <<= 1;
  const int per_block = kThreads / ipad;
  const int blocks = (n + per_block - 1) / per_block;
  tpcc_generate_kernel<<<blocks, kThreads, 0, dt_stream(stream)>>>(
      rng, n, ipt, ipad, n_wh, cust_per_dist, names, max_items, p_pay, p_mpr,
      by_last_index, txn_type, w_id, d_id, c_id, c_w_id, c_d_id, h_amount,
      ol_cnt, items, item_valid, supply_w, quantity, probe, use_mid);
  return dt_status();
}
