"""How many command-line tasks ran at once, on average over the window:
the children's walls inside the window, summed, over the window's
length (first start to last exit).  None where the driver ran none."""


def read(obs):
    busy, window = obs.get("children_s"), obs.get("loop_s")
    if not busy or not window:
        return None
    return busy / window
