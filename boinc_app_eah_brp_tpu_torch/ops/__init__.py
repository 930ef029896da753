"""Device operations of the search: FFT and power spectrum, whitening, the
resampler (kernels A and B) and the harmonic fold (kernel C), each kernel
beside its plain PyTorch version."""
