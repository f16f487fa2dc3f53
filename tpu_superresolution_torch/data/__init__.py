"""Host-side data of the port: image decode, the paired dataset index,
the threaded loader, and the on-device paired train transforms."""
