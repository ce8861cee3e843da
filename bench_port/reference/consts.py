"""Physical constants and unit conversions (CGS), geometrized units helpers.

Mirrors the constant set of the reference library (sim5const.h:32-95) so that
model outputs (fluxes, luminosities, spectra) are bit-comparable.
"""

TRUE = 1
FALSE = 0

# physical constants in CGS
grav_radius = 1.476716e+05       # gravitational radius GM/c2 of Sun [cm]
speed_of_light = 2.997925e+10    # [cm/s]
speed_of_light2 = 8.987554e+20   # [cm^2/s^2]
boltzmann_k = 1.380650e-16       # [erg/K]
sb_sigma = 5.670400e-05          # Stefan-Boltzmann [erg cm-2 s-1 K-4]
sigma_thomson = 6.652458e-25     # Thomson cross-section [cm^-2]
parsec = 3.085680e+18            # [cm]
mass_proton = 1.672622e-24       # [g]
mass_electron = 9.109382e-28     # [g]
solar_mass = 1.988920e+33        # [g]
grav_const = 6.673000e-08        # [cm3 g-1 s-2]
planck_h = 6.626069e-27          # [erg.s]
atomic_mass_unit = 1.660539e-24  # [g]
avogadro_number = 6.022141e+23   # [mol^-1]

# astrophysical constants
Mdot_Edd = 2.225475942e+18       # Eddington accretion rate [g/s * (M/Msun)]
L_Edd = 1.257142540e+38          # Eddington luminosity [erg/s * (M/Msun)]

# unit conversions
erg2kev = 6.241507e+08
kev2erg = 1.602177e-09
joule2kev = 6.241507e+15
joule2erg = 1.000000e+07
erg2joule = 1.000000e-07
kev2joule = 1.602177e-16
freq2kev = 4.135667e-18
freq2erg = 6.626069e-27
kev2freq = 2.417990e+17
msq2cmsq = 1.000000e+04
cmsq2msq = 1.000000e-04
kelvin2kev = 8.617342e-08
kev2kelvin = 1.160451e+07
m2cm = 1.000000e+02
cm2m = 1.000000e-02
kev2ev = 1.000000e+03
ev2kev = 1.000000e-03
