from .ranges import Interval, Position, interval_try_from_start_end, position_try_from
