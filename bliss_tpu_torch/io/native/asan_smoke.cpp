// ASAN/UBSAN smoke driver for the native decoder (SURVEY §5 race/memory
// sanitizer row). Decodes every argv path — including files expected to
// FAIL (exercising the error/cleanup paths) — under
// -fsanitize=address,undefined. Leaks, overflows, or UB abort the run.
//
// Build + run: `make -C bliss_tpu/io/native asan` (see ci_check.sh).
#include <cstdio>
#include <cstring>

struct DecodeResult {
  float *samples;
  long long n_samples;
  char *title, *artist, *album, *album_artist, *genre, *track, *disc;
  char *error;
};

extern "C" DecodeResult *bliss_decode(const char *path);
extern "C" void bliss_decode_free(DecodeResult *res);

int main(int argc, char **argv) {
  int decoded = 0, failed = 0;
  for (int i = 1; i < argc; i++) {
    DecodeResult *res = bliss_decode(argv[i]);
    if (!res) {
      std::fprintf(stderr, "NULL result for %s\n", argv[i]);
      return 2;
    }
    if (res->error) {
      failed++;
      std::printf("%s: error: %s\n", argv[i], res->error);
    } else {
      decoded++;
      // touch the full sample buffer so ASAN sees any bad bounds
      double acc = 0.0;
      for (long long j = 0; j < res->n_samples; j++) acc += res->samples[j];
      std::printf("%s: %lld samples (sum %.3f)%s%s\n", argv[i],
                  res->n_samples, acc, res->title ? " title=" : "",
                  res->title ? res->title : "");
    }
    bliss_decode_free(res);
  }
  std::printf("asan_smoke: %d decoded, %d failed-as-expected\n", decoded,
              failed);
  return decoded > 0 ? 0 : 1;
}
