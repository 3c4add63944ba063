// TSAN smoke driver for the native decoder (SURVEY §5 race-detection
// row). The production usage pattern is a host THREAD POOL calling
// bliss_decode concurrently (io/batch.py decode workers), so the smoke
// decodes every argv path from several threads at once under
// -fsanitize=thread. Races in our code abort the run; libav's own
// internals are suppressed via tsan.supp (uninstrumented library).
//
// Build + run: `make -C bliss_tpu/io/native tsan` (see ci_check.sh).
#include <atomic>
#include <cstdio>
#include <thread>
#include <vector>

struct DecodeResult {
  float *samples;
  long long n_samples;
  char *title, *artist, *album, *album_artist, *genre, *track, *disc;
  char *error;
};

extern "C" DecodeResult *bliss_decode(const char *path);
extern "C" void bliss_decode_free(DecodeResult *res);

int main(int argc, char **argv) {
  std::atomic<int> decoded{0}, failed{0}, broken{0};
  std::vector<std::thread> threads;
  const int rounds = 2;
  for (int t = 1; t < argc; t++) {
    threads.emplace_back([&, t] {
      for (int r = 0; r < rounds; r++) {
        DecodeResult *res = bliss_decode(argv[t]);
        if (!res) {
          broken++;
          continue;
        }
        if (res->error) {
          failed++;
        } else {
          double acc = 0.0;
          for (long long j = 0; j < res->n_samples; j++)
            acc += res->samples[j];
          (void)acc;
          decoded++;
        }
        bliss_decode_free(res);
      }
    });
  }
  for (auto &th : threads) th.join();
  std::printf("tsan_smoke: %d decoded, %d failed-as-expected, %d broken\n",
              decoded.load(), failed.load(), broken.load());
  return broken.load() ? 2 : 0;
}
