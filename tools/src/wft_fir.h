// Native FIR models: streaming Direct-Form-I + bit-exact fixed golden.
//
// Native equivalent of the reference's C++ model layer
// (fir_1d/model/cpp/fir_1d_ref.h:8-27).  Unlike the reference — whose
// static block model computed a full-mode convolution contradicting the
// Python same-mode contract (SURVEY.md C1) — every entry point here
// implements the single framework-wide same-mode center-aligned
// contract, so the native layer cross-checks bit-for-bit against the
// Python host and device paths.
#pragma once

#include <cstdint>
#include <vector>

namespace wft {

// Stateful sample-by-sample float FIR (delay-line, causal evaluation;
// emitted stream = same-mode output delayed by center = L/2 samples,
// matching ops/streaming.py semantics).
class Fir1DStream {
 public:
  explicit Fir1DStream(const std::vector<double>& taps) { set_taps(taps); }

  void set_taps(const std::vector<double>& taps);
  void reset();
  double process_sample(double x);
  std::vector<double> process_block(const std::vector<double>& x);

 private:
  std::vector<double> taps_;
  std::vector<double> delay_;  // delay_[k] = x[n-k]
};

struct QFormatSpec {
  int coeff_bits = 16;
  int frac_bits = 12;
  int acc_bits = 32;
};

// Bit-exact fixed-point golden over a row batch (same contract as
// fir_1d_fixed_ref.py:75-130 / models/golden.py): quantized taps are
// supplied pre-computed; MAC in int64, wrap to acc_bits, bias-round-
// shift, saturate to uint8.
void fir1d_fixed_rows(const std::uint8_t* x, std::int64_t batch,
                      std::int64_t width, const std::int64_t* taps_fixed,
                      std::int64_t num_taps, const QFormatSpec& spec,
                      std::uint8_t* out);

// Elementwise bit-compare of two uint8 buffers with error metrics —
// the golden-vector verification host tool (SURVEY.md §2.2 plan).
struct CompareResult {
  std::int64_t num_samples = 0;
  std::int64_t num_mismatches = 0;
  std::int64_t max_abs_err = 0;
  double mae = 0.0;
  double rmse = 0.0;
};

CompareResult bit_compare_u8(const std::uint8_t* a, const std::uint8_t* b,
                             std::int64_t n);

}  // namespace wft
