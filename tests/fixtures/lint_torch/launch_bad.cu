// Fixture for launch_bad.py and clean.py: a library's extern "C" interface.
#include <cuda_runtime.h>

extern "C" int toy_launch(const void* x, void* out, int n, void* stream) { return 0; }

extern "C" int toy_scale(void* x, int n, float s) { return n > 0 ? 0 : -1; }

extern "C" long long toy_bytes(int n) { return 4LL * n; }

extern "C" int toy_count(int n) { return n; }
