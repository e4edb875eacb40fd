"""SIM rule registry for the contract linter."""
from .sim001_tickets import Sim001Tickets
from .sim002_observers import Sim002Observers
from .sim003_hostsync import Sim003HostSync
from .sim004_counters import Sim004Counters
from .sim005_verdicts import Sim005Verdicts
from .sim006_retries import Sim006Retries
from .sim007_units import Sim007Units
from .sim008_seeds import Sim008Seeds
from .sim009_lifecycle import Sim009Lifecycle

ALL_RULES = (Sim001Tickets(), Sim002Observers(), Sim003HostSync(),
             Sim004Counters(), Sim005Verdicts(), Sim006Retries(),
             Sim007Units(), Sim008Seeds(), Sim009Lifecycle())

RULES_BY_ID = {r.rule_id: r for r in ALL_RULES}
