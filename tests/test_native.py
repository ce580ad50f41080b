"""Native C++ helpers vs their pure-NumPy fallbacks."""


def test_native_parser_and_grouper_report_availability():
    # The native parser builds where a C++ compiler exists; elsewhere the
    # import must still succeed and report False gracefully.
    from spmv_tpu.io import native as native_io

    assert isinstance(native_io.available(), bool)
