"""Analysis stack: delay spectra, delay CLEAN, power spectra, closure
phases and the bispectrum-phase pipeline.

Counterpart of prisim_tpu/analysis: cosmology, power_spectrum, closure and
bispectrum are host numpy copies; delay (the subband delay transform) and
clean (the batched Hogbom CLEAN) run on torch tensors on an explicit
device."""
