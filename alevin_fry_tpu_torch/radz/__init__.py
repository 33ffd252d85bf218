"""radz: the RAD container format layer of the port.

Parses the RAD container format consumed by alevin-fry (header + three
tag sections + file-tag values + chunked, tag-schema-driven records)
and reads and writes the binary sidecar formats passed between the
pipeline stages (permit_freq.bin / permit_map.bin / bincode maps /
unmapped counts) and the MatrixMarket output, and writes convert's RAD
files (:class:`RadWriter`), byte for byte as the
reference package's codec does.  It is host code (NumPy plus the
ctypes-bound ``csrc/libradc.so``, which it requires: ``_native.load``
raises when the library does not open) and imports neither torch nor
JAX.

Decoding produces *columnar* NumPy arrays (one array per field, with a
CSR alignment offset array) rather than per-record objects, so the
pipeline moves whole columns onto the device.
"""

from .header import RadHeader, RadPrelude, read_prelude  # noqa: F401
from .records import KnownRecordType, record_type_from_prelude  # noqa: F401
from .writers import RadWriter  # noqa: F401
