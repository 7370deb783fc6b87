"""The plain float64 reference that decides ``correct``: numpy on the
host, importing nothing of the program.

lsd.py, rdp.py and fa.py are a frozen copy of the port's numpy oracle
(lsdtpu_torch/oracle: createMapCache and the line segment detector of
LSD/myLSD.cpp, the scan featurization of LSD/myRDP.cpp, the matcher and
the UKF of LSD/myFA.cpp), made self-contained, with two changes: the
line detector's debug tracing is gone, and the log10 of a binomial term
that underflows to 0.0 is -inf, as in C (the oracle raises there, on
long walls of maps at data1's scale).  follow.py is the per-scan
reference of a stream and judge.py the comparisons and the control.
"""
