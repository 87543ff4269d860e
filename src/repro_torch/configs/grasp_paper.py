"""The paper's own evaluation configuration (Tables III-VI)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperEvalConfig:
    apps: tuple = ("bc", "sssp", "pr", "prd", "radii")
    high_skew: tuple = ("lj", "pl", "tw", "kr", "sd")
    adversarial: tuple = ("fr", "uni")
    reorderings: tuple = ("identity", "sort", "hubsort", "dbg", "gorder_lite")
    hw_baseline: str = "rrip"
    schemes: tuple = ("ship_mem", "hawkeye", "leeway", "grasp")
    pin_schemes: tuple = ("pin_25", "pin_50", "pin_75", "pin_100")
    llc_ways: int = 16
    scale: int = 15          # log2 vertices of the scaled datasets


CONFIG = PaperEvalConfig()
