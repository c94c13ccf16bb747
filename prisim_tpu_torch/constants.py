"""Physical constants used throughout prisim_tpu_torch.

The port's own copy of prisim_tpu/constants.py (numpy and scipy only): the
port imports nothing of the JAX package.

Mirrors the constants the reference pulls from ``scipy.constants`` and
``astroutils.constants`` (see PRISim's prisim/interferometry.py:89-235,
PRISim's prisim/delay_spectrum.py:356-395).
"""

# Speed of light (m/s) — exact by SI definition.
c = 299792458.0

# Boltzmann constant (J/K) — exact by SI definition (2019 redefinition).
k_B = 1.380649e-23

# Jansky in SI units (W m^-2 Hz^-1).
Jy = 1e-26

# Rest frequency of the HI 21 cm hyperfine transition (Hz).
rest_freq_HI = 1420405751.768

# Degrees <-> radians helpers live in numpy/jnp; only fixed scalars here.
