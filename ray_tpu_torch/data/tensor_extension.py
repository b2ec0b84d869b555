"""Arrow extension type for fixed-shape tensor columns.

The reference stores image/array columns as ArrowTensorType extension arrays
(python/ray/air/util/tensor_extensions/arrow.py) so a block holds ONE
contiguous buffer per tensor column instead of per-row objects. Same design
here, minimal surface: storage is FixedSizeList<storage_dtype>[prod(shape)],
element shape rides in the extension metadata, and conversion to/from numpy
is zero-copy (a reshape view over the flat values buffer).

This is what makes the ingest data plane cheap: a (N, H*W*C) uint8 image
column serializes as one out-of-band pickle-5 buffer into shm and comes back
as a zero-copy numpy view — no per-row bytes, no frombuffer/stack on the
trainer's hot loop.
"""

from __future__ import annotations

import json
import math
from typing import Tuple

import numpy as np
import pyarrow as pa


class ArrowTensorType(pa.ExtensionType):
    """Fixed-shape tensor column: each row is an ndarray of `element_shape`."""

    def __init__(self, element_shape: Tuple[int, ...], storage_dtype: pa.DataType):
        self._element_shape = tuple(int(s) for s in element_shape)
        size = int(math.prod(self._element_shape)) if self._element_shape else 1
        super().__init__(
            pa.list_(storage_dtype, size), "ray_tpu_torch.data.tensor"
        )

    @property
    def element_shape(self) -> Tuple[int, ...]:
        return self._element_shape

    def __arrow_ext_serialize__(self) -> bytes:
        return json.dumps(list(self._element_shape)).encode()

    @classmethod
    def __arrow_ext_deserialize__(cls, storage_type, serialized):
        shape = tuple(json.loads(serialized.decode()))
        return cls(shape, storage_type.value_type)

    def __arrow_ext_class__(self):
        return ArrowTensorArray

    def __reduce__(self):
        return (
            ArrowTensorType,
            (self._element_shape, self.storage_type.value_type),
        )


class ArrowTensorArray(pa.ExtensionArray):
    @staticmethod
    def from_numpy(arr: np.ndarray) -> "ArrowTensorArray":
        """Build a tensor column from a stacked (N, *element_shape) array.
        Zero-copy when `arr` is C-contiguous."""
        arr = np.ascontiguousarray(arr)
        if arr.ndim < 2:
            raise ValueError(
                f"tensor column needs a stacked (N, ...) array, got {arr.shape}"
            )
        element_shape = arr.shape[1:]
        size = int(math.prod(element_shape))
        flat_np = arr.reshape(-1)
        try:
            # Wrap the numpy buffer instead of pa.array(), which memcpys the
            # whole thing (~30 ms per 38 MB image block — the single biggest
            # ingest-path copy). py_buffer holds a reference to the numpy
            # memory, so the column keeps it alive.
            flat = pa.Array.from_buffers(
                pa.from_numpy_dtype(flat_np.dtype),
                len(flat_np),
                [None, pa.py_buffer(flat_np)],
            )
        except (pa.ArrowNotImplementedError, pa.ArrowInvalid, ValueError):
            flat = pa.array(flat_np)  # non-primitive dtypes
        storage = pa.FixedSizeListArray.from_arrays(flat, size)
        typ = ArrowTensorType(element_shape, flat.type)
        return pa.ExtensionArray.from_storage(typ, storage)

    def to_numpy_tensor(self) -> np.ndarray:
        """(N, *element_shape) numpy view — zero-copy when the storage is a
        single contiguous non-null chunk."""
        storage = self.storage
        values = storage.values
        # Respect a sliced storage array (offset/length in list elements).
        size = self.type.storage_type.list_size
        start = storage.offset * size
        flat = values.slice(start, len(storage) * size).to_numpy(
            zero_copy_only=False
        )
        return flat.reshape((len(storage),) + self.type.element_shape)


def tensor_column_to_numpy(col: pa.ChunkedArray) -> np.ndarray:
    """Materialize a (possibly chunked) tensor column as (N, *shape)."""
    if isinstance(col, pa.ChunkedArray):
        if col.num_chunks == 1:
            return col.chunk(0).to_numpy_tensor()
        return np.concatenate(
            [c.to_numpy_tensor() for c in col.chunks], axis=0
        )
    return col.to_numpy_tensor()


def is_tensor_type(t: pa.DataType) -> bool:
    return isinstance(t, ArrowTensorType)


_registered = False


def ensure_registered() -> None:
    """Register the extension type with pyarrow (idempotent; required for
    IPC/pickle round-trips to reconstruct ArrowTensorArray)."""
    global _registered
    if _registered:
        return
    try:
        pa.register_extension_type(ArrowTensorType((1,), pa.int64()))
    except pa.ArrowKeyError:
        pass  # already registered in this process
    _registered = True


ensure_registered()
