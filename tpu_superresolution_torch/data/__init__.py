"""Host-side data of the port: image decode (PIL and the native C++
decoder), the paired dataset index, the threaded loader with its
decoded-image cache, the on-device paired train transforms and the
MRCCM .mat preparation."""
