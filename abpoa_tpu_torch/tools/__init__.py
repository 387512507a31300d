"""Tools of the port: the device-loop fuzzer (``fuzz_device_loop``)."""
