"""Scripts run on the chip by hand to set the cells' parameters and
limits; the benchmark's runs do not run them."""
