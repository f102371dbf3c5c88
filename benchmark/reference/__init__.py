"""The benchmark's plain reference for k-way alignment by sum of pairs.

Written from the reference program's semantics (``seqalign-mpi-skeleton.cpp``:
the DP at :186-235, the traceback and its tie-break at :236-262, the prefix
completion at :263-272, the gap trim at :135-144, the hash chain at
:155-159), in plain PyTorch and NumPy. It imports nothing of the program
under test, and takes nothing the program made: it is handed the same
sequences the program is handed, and reads the program's outputs only to
judge them (``msabench/judge.py``).

- ``nw``        penalties and traceback moves of a batch of pairs, a DP row
                at a time in plain torch ops (on the card or the CPU);
- ``alignment`` moves -> the two aligned strings;
- ``hashing``   pair hash and the SHA-512 chain;
- ``tasks``     the canonical pair order.
"""
