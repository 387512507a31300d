"""Tools of the port: the device-loop fuzzer (``fuzz_device_loop``) and
the CLI's differential fuzzer (``fuzz_ref``)."""
