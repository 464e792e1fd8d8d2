// Measure the reference's 16-transform orbit enumeration (GetOctoHash,
// Symmetry.hpp:774-785): per board, 16 Transformed() images, XYBounds
// origin-normalization, and a 64-bit hash of each image, XOR-combined.
//
// Built against a shimmed copy of the reference headers (see
// run_ref_orbit.py: GCC compatibility shim + a splitmix-style stub for the
// absent xxHash submodule -- hashing 512 bytes is a small, comparable cost
// either way).  Same measurement style as BASELINE.md: single thread,
// -O3 -march=native, wall-clock over enough iterations to dwarf timer
// noise.
#include <chrono>
#include <cstdint>
#include <cstdio>

#include "LifeAPI.hpp"
#include "Symmetry.hpp"

int main() {
  const int B = 512;   // distinct random boards
  const int M = 40;    // passes over them
  LifeState boards[B];
  for (int i = 0; i < B; i++)
    boards[i] = LifeState::RandomState();  // p=0.5 dense, like bench.py's orbit sweep

  // warm pass (also defeats over-clever dead-code elimination)
  uint64_t sink = 0;
  for (int i = 0; i < B; i++) sink ^= boards[i].GetOctoHash();

  auto t0 = std::chrono::steady_clock::now();
  for (int m = 0; m < M; m++)
    for (int i = 0; i < B; i++)
      sink ^= boards[i].GetOctoHash();
  auto t1 = std::chrono::steady_clock::now();
  double dt = std::chrono::duration<double>(t1 - t0).count();

  double per_sec = (double)B * M / dt;
  printf("{\"metric\": \"ref_orbit_sweeps_per_sec\", \"value\": %.6g, "
         "\"unit\": \"orbits/s\", \"sink\": %llu}\n",
         per_sec, (unsigned long long)(sink & 0xFF));
  return 0;
}
