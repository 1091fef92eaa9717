// The dynamic shared-memory limit of a kernel, raised once a device: shared
// by the kernels of dp_align.cu and diag_counts.cu.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

// Raise a kernel's dynamic shared-memory limit on the current device once,
// to the largest size a launch has asked for, instead of on every launch.
inline cudaError_t allow_shared_bytes(const void* kernel, size_t bytes)
{
    static std::mutex lock;
    static std::map<std::pair<const void*, int>, size_t> allowed;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> guard(lock);
    size_t& have = allowed[std::make_pair(kernel, device)];
    if (bytes <= have) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) have = bytes;
    return err;
}

}  // namespace
