// Mock LAMMPS Memory (see lammps.h for why this tree exists).
#ifndef LMP_MEMORY_H
#define LMP_MEMORY_H

#include <cstddef>

#include "pointers.h"

namespace LAMMPS_NS {

class Memory {
 public:
  // 2-D row-pointer array backed by one contiguous zeroed block (the
  // LAMMPS create/destroy contract)
  template <typename T>
  T** create(T**& arr, int n, int m, const char* /*name*/) {
    T* block = new T[static_cast<size_t>(n) * m]();
    arr = new T*[n];
    for (int i = 0; i < n; ++i) arr[i] = block + static_cast<size_t>(i) * m;
    return arr;
  }

  template <typename T>
  void destroy(T**& arr) {
    if (!arr) return;
    delete[] arr[0];
    delete[] arr;
    arr = nullptr;
  }
};

}  // namespace LAMMPS_NS

#endif
