"""VACASK benchmark-suite circuits (reference `benchmarks/vacask/*`), the
netlists of `cadnip_tpu/models/vacask.py` copied as text: rc, graetz (the
four-diode rectifier) and mul (the diode voltage multiplier); and the
darlington (two cascaded NPNs switched by a 500 kHz pulse train, whose
benchmark runs `tran 2n 1m`), the text of bench.py's DARLINGTON.
"""

RC_NETLIST = """RC circuit excited by a pulse train
vs 1 0 dc 0 pulse 0 1 1u 1u 1u 1m 2m
r1 1 2 1k
c1 2 0 1u
.end
"""

GRAETZ = """Full-wave rectifier with smoothing and load
.model d1n4007 d is=76.9p rs=42.0m bv=1.00k ibv=5.00u cjo=26.5p  m=0.333 n=1.45
vs inp inn 0 sin 0.0 20 50.0
d1 inp outp d1n4007
d2 outn inp d1n4007
d3 inn outp d1n4007
d4 outn inn d1n4007
cl outp outn 100u
rl outp outn 1k
rgnd1 inn 0 1meg
rgnd2 outn 0 1meg
.end
"""

MUL = """Diode cascade
.model D1N4007 D IS=76.9p RS=42.0m BV=1.00k IBV=5.00u CJO=26.5p  M=0.333 N=1.45
.param c=100n
vs a 0 dc=0 sin 0 50 100k
r1 a 1 r=0.01
c1 1 2 c={c}
d1 0 1 d1n4007
c2 0 10 c={c}
d2 1 10 d1n4007
c3 1 2  c={c}
d3 10 2 d1n4007
c4 10 20 c={c}
d4 2 20 d1n4007
.end
"""

DARLINGTON = """Darlington pair switch driven by a pulse train
.model qmod npn bf=100 is=1e-15 cje=10p cjc=5p tf=0.3n
vcc vcc 0 dc 5
vs vin 0 dc 0 pulse 0 3 0 10n 10n 0.99u 2u
rb vin b1 10k
q1 coll b1 b2 qmod
q2 coll b2 0 qmod
rbleed b2 0 10k
rl vcc coll 1k
cl coll 0 100p
.end
"""
