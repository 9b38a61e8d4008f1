"""Command-line tools beside the library: the gradient-compression bench
(``compress_bench``) and the roofline over measured records (``roofline``)."""
