// A stand-alone probe of what a round of a cluster kernel pays, built and
// run by `chip_smoke.py --cluster-costs` (not part of the kernel
// library): the device time of one barrier of a cluster of C CTAs x 1024
// threads in four forms, and of back-to-back launches (the host's
// enqueue hidden behind a spinning kernel), plain, as a cluster, and as a
// pair with and without programmatic dependent launch.  K8 and K16
// (conflict.cu, depgraph.cu) move data between CTAs by st.async and use
// one relaxed cluster barrier because of these costs.
#include <cooperative_groups.h>

#include <cstdio>

namespace cg = cooperative_groups;

namespace {

// V: 0 cluster.sync(), 1 arrive.release + wait.acquire, 2 arrive.relaxed
// + wait, 3 __syncthreads, 4 a remote store then cluster.sync().
template <int V>
__global__ void barrier_kernel(int n, int* sink) {
  __shared__ int x[64];
  cg::cluster_group cl = cg::this_cluster();
  int acc = 0;
  for (int i = 0; i < n; ++i) {
    if (V == 4 && threadIdx.x < cl.num_blocks())
      *cl.map_shared_rank(x + (i & 31), threadIdx.x) = i;
    if (V == 0 || V == 4) {
      cl.sync();
    } else if (V == 1) {
      asm volatile(
          "barrier.cluster.arrive.release.aligned;\n"
          "barrier.cluster.wait.acquire.aligned;" ::: "memory");
    } else if (V == 2) {
      asm volatile(
          "barrier.cluster.arrive.relaxed.aligned;\n"
          "barrier.cluster.wait.aligned;" ::: "memory");
    } else {
      __syncthreads();
    }
    acc += x[i & 31];
  }
  if (acc == 12345) *sink = acc;
}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

__global__ void empty_kernel(int* p) {
  if (p != nullptr && threadIdx.x == 12345) *p = 1;
}

__global__ void primary_kernel(int* p) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (p != nullptr && threadIdx.x == 12345) *p = 1;
}

__global__ void secondary_kernel(int* p) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (p != nullptr && threadIdx.x == 12345) *p = 1;
}

cudaError_t launch(void (*k)(int*), int grid, int cluster, bool pdl,
                   cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(1024);
  cfg.stream = s;
  cudaLaunchAttribute a[2];
  int n = 0;
  if (cluster > 0) {
    a[n].id = cudaLaunchAttributeClusterDimension;
    a[n].val.clusterDim.x = cluster;
    a[n].val.clusterDim.y = 1;
    a[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    a[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    a[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = a;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, k, static_cast<int*>(nullptr));
}

// Device microseconds per call of f, the host's enqueue hidden.
template <typename F>
float device_us(F f, int n = 400) {
  for (int i = 0; i < 20; ++i) f();
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  spin<<<1, 1>>>(40000000LL);
  cudaEventRecord(e0);
  for (int i = 0; i < n; ++i) f();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms * 1e3f / n;
}

template <int V>
float barrier_ns(int c) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(1024);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = c;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  const int n = 10000;
  const float with = device_us(
      [&] { cudaLaunchKernelEx(&cfg, barrier_kernel<V>, n, nullptr); }, 20);
  const float without = device_us(
      [&] { cudaLaunchKernelEx(&cfg, barrier_kernel<V>, 0, nullptr); }, 20);
  return (with - without) * 1e3f / n;
}

}  // namespace

int main() {
  const char* names[] = {"cluster.sync()",
                         "arrive.release + wait.acquire",
                         "arrive.relaxed + wait", "__syncthreads()",
                         "a remote store + cluster.sync()"};
  for (int c : {1, 2, 4, 8}) {
    const float t[5] = {barrier_ns<0>(c), barrier_ns<1>(c), barrier_ns<2>(c),
                        barrier_ns<3>(c), barrier_ns<4>(c)};
    for (int v = 0; v < 5; ++v)
      printf("[cluster-costs] barrier, cluster of %d x 1024 threads, %s: "
             "%.1f ns\n", c, names[v], t[v]);
  }
  printf("[cluster-costs] launch <<<1, 1024>>>: %.2f us\n",
         device_us([] { empty_kernel<<<1, 1024>>>(nullptr); }));
  for (int c : {1, 4, 8}) {
    printf("[cluster-costs] launch, a cluster of %d: %.2f us\n", c,
           device_us([&] { launch(secondary_kernel, c, c, false, 0); }));
    printf("[cluster-costs] pair <<<128, 1024>>> then a cluster of %d: "
           "%.2f us; with programmatic dependent launch: %.2f us\n", c,
           device_us([&] {
             primary_kernel<<<128, 1024>>>(nullptr);
             launch(secondary_kernel, c, c, false, 0);
           }),
           device_us([&] {
             primary_kernel<<<128, 1024>>>(nullptr);
             launch(secondary_kernel, c, c, true, 0);
           }));
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("[cluster-costs] %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
