"""The benchmark's yardstick: the plain reference of each configuration
(``net``) and the work counts and peaks the per-layer metrics divide by
(``counts``). Imports nothing of the program under test."""
