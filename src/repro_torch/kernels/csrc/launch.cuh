// Host-side launch helper shared by the kernel sources.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

// cudaFuncSetAttribute acts on the current device only, so a launcher
// that drives kernels on several devices (tensor-parallel shards) raises
// a kernel's dynamic shared memory limit once per device; later launches
// on that device get the result of that one call.
inline cudaError_t max_dynamic_smem(const void* kernel, int bytes) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, cudaError_t> done;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, dev);
  auto it = done.find(key);
  if (it == done.end())
    it = done.emplace(key, cudaFuncSetAttribute(
                               kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes)).first;
  return it->second;
}

}  // namespace
