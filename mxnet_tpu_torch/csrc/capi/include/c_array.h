// The host-side NDArray the C API hands out as NDArrayHandle
// (reference: include/mxnet/ndarray.h NDArray behind c_api.h handles).
// Shared between the NDArray C API (src/c_api_ndarray.cc) and the training
// C API (src/c_api_train.cc: MXImperativeInvoke outputs, monitor-callback
// arrays) so a handle created by one family is readable by the other —
// mirroring the reference where every family shares one NDArray type.
#ifndef MXTPU_C_ARRAY_H_
#define MXTPU_C_ARRAY_H_

#include <cstdint>
#include <vector>

#include "ndarray_wire.h"

typedef unsigned int mx_uint;

struct CArray {
  std::vector<mx_uint> shape;
  std::vector<uint8_t> data;
  int dtype = 0;     // mshadow flag (size table: ndarray_wire.h)
  int dev_type = 1;  // cpu
  int dev_id = 0;
  bool none = false;  // MXNDArrayCreateNone / delay_alloc placeholder
};

#endif  // MXTPU_C_ARRAY_H_
