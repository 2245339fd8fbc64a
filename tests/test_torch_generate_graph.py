"""Every registered id's generator as a CUDA graph capture would take it,
checked on the CPU.

On a CUDA device the "regen" rollout (``parallel/lanes.py``) and PPO's
"regen" collector capture ``env.generate`` inside their step's graph, so
each generator must be a fixed-shape program with no host step: no
tensor made from Python data, no value read back to the host, no output
whose shape depends on data.  Here:

* every id's ``generate`` at B=4 runs under ``_torch_graph.py``'s
  ``NoHostReads`` after one warm-up call (the capture's warm-up makes
  the constant tables, ``ops/grid.py:const``);
* every id's layouts from seeds 0 and 1 at B=8 keep the sha256 digests
  in ``DIGESTS``, those of the generators before they were made
  capturable: no draw moved, and every value is the same; a CPU
  ``generate`` launches no generator kernel (``csrc/doorkey_gen.cu``);
* the BabyAI flood fill (``envs/babyai/level.py:objs_reachable``), which
  runs its fixed bound of sweeps, equals a fill run to its fixed point on
  hand-made mazes.
"""

from __future__ import annotations

import dataclasses
import hashlib

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREY,
    OBJ_BALL,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    OBJ_WALL,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import new_state
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import level as blevel
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

from ._torch_graph import NoHostReads

torch.set_num_threads(1)

IDS = port.registered_ids()


def digest(state) -> str:
    """sha256 of every field of a batch-first state: name, dtype, shape
    and bytes, in the record's field order."""
    h = hashlib.sha256()
    for f in dataclasses.fields(state):
        t = getattr(state, f.name).contiguous()
        h.update(f"{f.name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def layouts_digests(env_id: str) -> tuple:
    env = port.make(env_id)
    return tuple(
        digest(env.generate(torch.Generator().manual_seed(s), env.params, 8, "cpu"))
        for s in (0, 1)
    )


def test_every_id_is_listed():
    assert len(IDS) == 171 and set(IDS) == set(DIGESTS)


@pytest.mark.parametrize("env_id", IDS)
def test_generate_reads_nothing_to_the_host(env_id):
    env = port.make(env_id)
    env.generate(torch.Generator().manual_seed(0), env.params, 4, "cpu")  # warm-up
    with NoHostReads():
        state = env.generate(torch.Generator().manual_seed(1), env.params, 4, "cpu")
    assert state.grid_obj.shape == (4, env.params.height, env.params.width)


@pytest.mark.parametrize("env_id", IDS)
def test_layouts_equal_the_earlier_generators(env_id):
    """From seeds 0 and 1 on the CPU, where no id launches DoorKey's
    generator kernel."""
    launches = profiling.counter("generator.kernel.launches")
    assert layouts_digests(env_id) == DIGESTS[env_id]
    assert profiling.counter("generator.kernel.launches") == launches


def _maze(rows: list) -> "port.EnvState":
    """One layout from text: '#' wall, 'D' door, 'K' key, 'B' ball, 'A'
    the agent's cell, '.' empty."""
    codes = {"#": OBJ_WALL, "D": OBJ_DOOR, "K": OBJ_KEY, "B": OBJ_BALL, ".": OBJ_EMPTY, "A": OBJ_EMPTY}
    h, w = len(rows), len(rows[0])
    state = new_state(1, h, w, torch.device("cpu"))
    obj = torch.tensor([[codes[c] for c in row] for row in rows], dtype=torch.uint8)
    (ay, ax), = [(y, x) for y, row in enumerate(rows) for x, c in enumerate(row) if c == "A"]
    return state.replace(
        grid_obj=obj[None],
        grid_color=torch.where(obj == OBJ_WALL, COLOR_GREY, 0).to(torch.uint8)[None],
        agent_pos=torch.tensor([[ax, ay]], dtype=torch.int32),
    )


def _reachable_to_fixed_point(state) -> torch.Tensor:
    """``objs_reachable`` with the flood swept until it stops growing."""
    obj = state.grid_obj
    passable = (obj == OBJ_EMPTY) | (obj == OBJ_DOOR)
    b, h, w = obj.shape
    reach = torch.zeros_like(passable)
    reach[torch.arange(b), state.agent_pos[:, 1].long(), state.agent_pos[:, 0].long()] = True
    while True:
        grown = reach | blevel._adjacent(reach & passable)
        if torch.equal(grown, reach):
            break
        reach = grown
    is_obj = (obj != OBJ_EMPTY) & (obj != OBJ_WALL)
    return (~is_obj | reach).reshape(b, -1).all(dim=1)


# A serpentine whose far end is 31 sweeps from the agent (the bound at
# 11x11 is 62); the same with its ball walled off; a door on the way; the
# agent boxed in.
MAZES = {
    "serpentine": ([
        "###########",
        "#A........#",
        "#########.#",
        "#.........#",
        "#.#########",
        "#.........#",
        "#########.#",
        "#.........#",
        "#.#########",
        "#........B#",
        "###########",
    ], True),
    "walled_off": ([
        "###########",
        "#A........#",
        "#########.#",
        "#.........#",
        "#.#########",
        "#.........#",
        "#########.#",
        "#.........#",
        "###########",
        "#........B#",
        "###########",
    ], False),
    "through_a_door": ([
        "#######",
        "#A.#..#",
        "#..D.K#",
        "#..#..#",
        "#######",
    ], True),
    "boxed_in": ([
        "#######",
        "#A#...#",
        "###.K.#",
        "#.....#",
        "#######",
    ], False),
}


@pytest.mark.parametrize("name", sorted(MAZES))
def test_fixed_bound_flood_equals_the_fill_to_its_fixed_point(name):
    rows, want = MAZES[name]
    state = _maze(rows)
    got = blevel.objs_reachable(state)
    assert got.tolist() == _reachable_to_fixed_point(state).tolist() == [want]


# sha256 of the layouts of seeds 0 and 1 (B=8, on the CPU), made by the
# generators before they were made capturable.
DIGESTS = {
    "BabyAI-ActionObjDoor-v0": (
        "ddc86814c2dfb96d452465f08a9e22084c0d61c78f40201ee68c9263a471a6f6",
        "cce9115ebbcfeafac27da67b1348c476fbc4d17bb6872867ca6daedba47fbf6c",
    ),
    "BabyAI-BlockedUnlockPickup-v0": (
        "89063ae1ea709388576425684ca57069876f1825d5feefbfdfc518bbf53f983a",
        "723f9f98594a859e6bcd54a3ce717d3550142e6c325be06d83c16c76a623b45e",
    ),
    "BabyAI-BossLevel-v0": (
        "ba2e9b90c95f1a812e0c08a1567b59b6c454c084e3c43d7b1a5c4f44499aaf6d",
        "024100e8e90a22f6634cf252dec146e247f46df895ea9c98a16c3da384bba9e5",
    ),
    "BabyAI-BossLevelNoUnlock-v0": (
        "9acf40358adefe15a098fb29a1077f6096fabb0a8efcee4d9f1aca20f166b6a3",
        "6cc83a1c60ac6eba27328ebd4f1f7d1fecf7f90dd0e6045de8567cce073dd6bb",
    ),
    "BabyAI-FindObjS5-v0": (
        "cd2def5d6de6a1b3093ac2ddb901f4b890a6ca3e5c67e8c8dfbe133a21264208",
        "c12156326848ac99750aee99b430a55f634f9cd149f15fb801c8b0eed8bd4fa5",
    ),
    "BabyAI-FindObjS6-v0": (
        "cfe743f76bedf8b926ce505d83d5f8e6a4813423308efb7d3a6b5f0fb149e7ed",
        "79ac14b245ca49d20930a99bdfa7c61d20747aa0eb3cdbd5ea546869a1ceb678",
    ),
    "BabyAI-FindObjS7-v0": (
        "eca0d2d4c8f11ba40cf0358478a875eab9e7cd4aca162bf1a5af73712283d97f",
        "a6ead801578f64b11a8dce487495b3df377900655a4e404953060534f50edd24",
    ),
    "BabyAI-GoTo-v0": (
        "2f158a1160fbe262462c458c91be224a793348471b158b9109d727217e932a19",
        "3e5701afa054fc65ebf6ce9d89160bfd5cf685dbd3350f33d960725b6bbe09a4",
    ),
    "BabyAI-GoToDoor-v0": (
        "c765fddb4cbab73c38f1e2bac2ae59d166887b904c46f8946b51196d23521970",
        "7b7ba52e88c971a1d72bfa76a7bb65c7f06cfb82dabad2d57dee85839661ef1a",
    ),
    "BabyAI-GoToImpUnlock-v0": (
        "6278eae3d38992e00ff613665730cd6dde4dedaf51257e328b252970e0507eef",
        "4825015dbf17ec4efc4cc0872a0496b928abf8a1f86d0bcb9189dd3ebf80c6ad",
    ),
    "BabyAI-GoToLocal-v0": (
        "b6bfd79f17fc31ccbb5af809b0fbf427cbe1ca8388e16be66cba13628c1b37e7",
        "5d6bb26505c293813c478352a603b2a3242e701658092c3613d48548c21f8b80",
    ),
    "BabyAI-GoToLocalS5N2-v0": (
        "55e8a53d865cdd874328c088cbd2a54f9cb037271542c8bcbbb8bc3eae7dfffc",
        "4a6c2d7e2fbe7d8a2ef6dc0862ffbab85a4cfa3149379e5474743806c6a97390",
    ),
    "BabyAI-GoToLocalS6N2-v0": (
        "4d8891cd82e7ad2f5210ec238665b25d25332f3792eebf8a24156e745123742c",
        "3aa1599bb4bff889ceedc30266fda51a03e17f2da8f29e59d2afdc94423d5a5e",
    ),
    "BabyAI-GoToLocalS6N3-v0": (
        "438141f629d06ec8f212798dfb90137f7fe51b547c6628acd544292f4777df67",
        "180b339adea0c8917eeaaf184ada0357f60e8693e75801a32a43bea75ae7ef8c",
    ),
    "BabyAI-GoToLocalS6N4-v0": (
        "5f5a115c86a07636e0b6de64fbd4b87d0ac990d27d7ea998ed29634f9ddbe4bc",
        "f6e2f32ba8598f7a57f700fbf63679191846584d006c88e7658f02376ddd688f",
    ),
    "BabyAI-GoToLocalS7N4-v0": (
        "7079f7a2dc360c58de4bdb2db9a1a63d90b13b31f48980573b4c055f1a286585",
        "5507792103a4ec8ede1d5272e62f4cf8e91793a8119d7ae375ebb2d94bbdfdc1",
    ),
    "BabyAI-GoToLocalS7N5-v0": (
        "9ed39ee9439a50d617cc8c35216e7c6a9f483b999170a5172616622529032150",
        "ce03e54ab14090f583e643b3779de2b609d6e88cc58ce95a4d9c5c9f72ce5671",
    ),
    "BabyAI-GoToLocalS8N2-v0": (
        "c7cce9a82b95b43935f5fc40471db6f27253f26732ee10dbacd0f81bd3c6fb02",
        "f1c52cd5951a6f67003f7eb3bfc21d9b6b5b9fc9fea1dbabdcfb534853047daf",
    ),
    "BabyAI-GoToLocalS8N3-v0": (
        "b5a0a14750d43228f07ee6e6b83cb90ade419fe067589ef55c91ca7445a579cc",
        "50cf69b2c96be3dc4f19d9293757f909d23b87afec4d714cbe756074b056172c",
    ),
    "BabyAI-GoToLocalS8N4-v0": (
        "114ae8917b0c950e3abb8a9f0d1628060fda4bae83c01cd7627398b25e3b36ce",
        "63961ffaba2c7adfc6ca9f48ddd50fecc7c03671082d016e9b5c8b56e77e48eb",
    ),
    "BabyAI-GoToLocalS8N5-v0": (
        "c9769b9177fd054a4ed9d0b4d6e0e065aa725db4e59383572a0944a24d86349d",
        "7ae2cbfcb5ce352cb1b3612ed947c75f049fb34183f5086c0c4426c9dafdc793",
    ),
    "BabyAI-GoToLocalS8N6-v0": (
        "6f2b45976774a931997d42aec870a7f55eac9f11ab9c3a0c3e86b44973c0c435",
        "b8582e3d945ae937e440f50fb9f90d412dc4bc68b374628dc85aec774386bb8e",
    ),
    "BabyAI-GoToLocalS8N7-v0": (
        "94f9b9f613199bb08bb3771c1aa5a30992108ba12c1670b434b5cb20318fc0ed",
        "04d7c274eb9afc2844360d26854747ea1f33c8f1a1b2967c99535afe9bde590e",
    ),
    "BabyAI-GoToObj-v0": (
        "b1e8597486d3a53fb377b534f6d33dfc471351e69e7e74238e96cfc0f2ac64b8",
        "7bdafe752a79cda59d9bffe423c55d269ae37e58ef2e5e934956c560df1d33ca",
    ),
    "BabyAI-GoToObjDoor-v0": (
        "5dc6087e55dc34e6811ba37badc31dd326aacb3e61fdabad5ce0de020a4c4933",
        "de74cfd8c7c239d349e70c8e5647f83412815deff43175fdae4f7fce424a3991",
    ),
    "BabyAI-GoToObjMaze-v0": (
        "33794373feb3ad46b8084b5a8ef4566c0d356beadf11da0b4080f9b576a83b28",
        "ac1797ac4746c030ca6ee43f8c637ced2814a2de9944bc596ec855cb18101846",
    ),
    "BabyAI-GoToObjMazeOpen-v0": (
        "cc835535aeb1955d4e809f9a43da1554b09145801bb06916408437b945adfa7c",
        "9f880b997d861951214b4b0eb9c2589b054ac1741f046143665a7ad35d4d06df",
    ),
    "BabyAI-GoToObjMazeS4-v0": (
        "7fcffcebdea9a76d1c8346de3870683205f773cd0af88d12c1398d2c3d33a0e8",
        "6f1fa28c9e91dd88a4e3c080add2ad8cec7cec1f332da00509e4c7d3f21550fa",
    ),
    "BabyAI-GoToObjMazeS4R2-v0": (
        "d68ca1c2d156748b9941b71f91745e45ca9398ffdb8e07b8c7435da60971f241",
        "80eb4d6f268765f482c78c8dd09dadb8158305fb8c0d74e8e8c360b46e05eb62",
    ),
    "BabyAI-GoToObjMazeS5-v0": (
        "aeb8f74c9b64a2097e18ff1702c28aeebaee9faaad0f6f92eb3d79ac83524d39",
        "3374ddf29903897abdbf9de7793ec6bb1c241e5013b250262dd1a29382a9edca",
    ),
    "BabyAI-GoToObjMazeS6-v0": (
        "85daba54922973cde1cc5601200804d2498b755a8d9df4da017487f0aed8d5e5",
        "a9cb960665bdc061f3bbf5dfe9366fc609c29b2160024f9c5f1b17f5bc888d8b",
    ),
    "BabyAI-GoToObjMazeS7-v0": (
        "b267523868b2d5cac1df4912e3092694a02662deef5942ae3e5e5821f69a39d3",
        "ce3407c47e7123450069298b6dd9aff61dfebb4898338a169a696b69247cc0bd",
    ),
    "BabyAI-GoToObjS4-v0": (
        "bb49fbef0ad87f67e1fa1ae5828515cdbad31e543eedbd2781576cd8252adb9a",
        "62d2d826b853954d3718860eeb01243f0288b88ff7fe0d49f0545965e7a91c31",
    ),
    "BabyAI-GoToObjS6-v1": (
        "62187cc5f4f922cbb017d7777ac0c47b40ecf642d81e0527ca6d045cbeff96f5",
        "0a13d588252a3990d94b5a70ad28dedb93cd5a94fe8f3dafc5d6ca06e03e0bb6",
    ),
    "BabyAI-GoToOpen-v0": (
        "8cc985f7f6a001ec9dec1822d22b55ae30af02901c5074f95747a3cb7e62dc7f",
        "88a9bd933ed14ccf9a133e9d86626fac2553a998e75b540d57fdcdf64bc82a9e",
    ),
    "BabyAI-GoToRedBall-v0": (
        "266def79a82bcd96fa57233d2883fd1c5cc98dde42ae1f26be3fce9404a92e01",
        "715d52993347df1221efb61d007f0baa9c71b101b2926a60f69b34ae959bb26f",
    ),
    "BabyAI-GoToRedBallGrey-v0": (
        "43de4a12991cae20f8706223383585763e38bc3800acac5705c9a2f17e2469b9",
        "f763e14b84682de32516a3e851a1b7ecb81aa2de6b761fe8c811093ae326d8bd",
    ),
    "BabyAI-GoToRedBallNoDists-v0": (
        "884731289686213f41d2a54b9a6c770d3557db25eb803d3de80b7b53ed37ab43",
        "82efb6011c6591013e30fcb6d996a17a16b439e15998cd58c8ecccd786ed10c8",
    ),
    "BabyAI-GoToRedBlueBall-v0": (
        "fa22d4b13e3445938b63dc5ac07ce21ae90218d5177ea3da1f1cf43731e737e5",
        "0e5a8c589802e6ff7446e5486587f967a39455c8001eb9b229cf8048c3c4dbff",
    ),
    "BabyAI-GoToSeq-v0": (
        "cbddd616d6ea41fb0c33fd635e791894576ceacbd92f0f1ffe1489da3c7a29c0",
        "6f0e54baf90ed3f7b1adf1b38cd938cc1181d1a5076b797879bb20f304928fd0",
    ),
    "BabyAI-GoToSeqS5R2-v0": (
        "d5bf3e499c0d0741f5c914b2c6ba8295c24d886bb4b37fca2242e35dd5229333",
        "da2a5c014635a9d7a70f3bf6eef49470d3614725b69a59ea20d755863f16aba9",
    ),
    "BabyAI-KeyCorridor-v0": (
        "66092520f939f58544b7fbcc0b6e92ff91a1df7563551535897c305093cdda73",
        "7d9c03206f4c6c3d51b2e98f64974787baea0ae2ec63d9be312d821fff07ba68",
    ),
    "BabyAI-KeyCorridorS3R1-v0": (
        "9572eb557c92f3aa1427b8fdff9392196539b592c495af79e5d996a73aa6bbdb",
        "a60468454d30184ee071093eeb568f75dc1e05694a5139e0e180da11af294a06",
    ),
    "BabyAI-KeyCorridorS3R2-v0": (
        "6695db7975a27501c6df41a850ead5bcd8624c0eebb2e99a18297e9eaa6569b7",
        "53ea73a49c898d31b207d0eb8ad33e2c4150a45a5b23158817c886c20734a79b",
    ),
    "BabyAI-KeyCorridorS3R3-v0": (
        "d4e90a98b0d95eccbca2efe054c96c6bf20774a7c131b729a94fbae7f2e39247",
        "56ff17bc504dcf9bcc23d940589d6492ca21929ee1f65a7a56fac02e2915aac7",
    ),
    "BabyAI-KeyCorridorS4R3-v0": (
        "bda01f0a8c42fc4471c8cf57d4ce2f478d0e0d02cedaaa04499d9979ee92801f",
        "756107b00cac500e683c864c56fadfaae0c606ed700c95a61619e651296d546c",
    ),
    "BabyAI-KeyCorridorS5R3-v0": (
        "cea161bb8f9641950cefa52b98894974b0c1fadee039a0e59e2899674273bf51",
        "c31fa62a7fb2e126ae47d4cfb56b9171e8276620578eb64e82735f66579de3ba",
    ),
    "BabyAI-KeyCorridorS6R3-v0": (
        "66092520f939f58544b7fbcc0b6e92ff91a1df7563551535897c305093cdda73",
        "7d9c03206f4c6c3d51b2e98f64974787baea0ae2ec63d9be312d821fff07ba68",
    ),
    "BabyAI-KeyInBox-v0": (
        "aeeb17b0b1184ff0468e0eb9cbe1054f257caa61c84351093ba54cc7e023c811",
        "a68ca2e536a5783ec34750d1fbe6443a11e2bf6b2bf66a0ff3fff02f9e50b193",
    ),
    "BabyAI-MiniBossLevel-v0": (
        "bec797f97385ff6cf0815123123ffa00d63a5802205dfb0b9ba52844c4ccd3da",
        "52e05c5d6394aae84188fcd1268236b13fcf30f679da3dc907cc59b32c8f377d",
    ),
    "BabyAI-MoveTwoAcrossS5N2-v0": (
        "4df0ccd841d82e1a7cbb91d214deb7e7caf5479cef8e09bd5871d26a47b4b6f7",
        "6f86627a816e2ab5a0dd15aa394aae8611cfe8ef200896d54e8c62a9e58a4f3a",
    ),
    "BabyAI-MoveTwoAcrossS8N9-v0": (
        "43d59757ce899900cb83d610817c02ddf6d0a53db2f9283426c9f4f5e7694f63",
        "f8e71872fdad16786a941fddbf049a80423ff14c99ae345de5a1603306abdf33",
    ),
    "BabyAI-OneRoomS12-v0": (
        "b8d13c40e12204da91e3652931440d4c82f20b2749fa575a438378aa3cf9ce92",
        "bbabac5e82e400d7b721539eb2686c1a4e98ccc4063b4d7d162f98702b075922",
    ),
    "BabyAI-OneRoomS16-v0": (
        "983b9c4638897c05cd84ea6d3cea5148d4f4c3b2eecb054f6e6844fd66cfce13",
        "8cdcd8200bd94a4f50fbb089cfea139329e4d6d9de154c95c4cdc2e5c5f80087",
    ),
    "BabyAI-OneRoomS20-v0": (
        "260fe9b946e9390f8570343907a8b2bd494a4e0fe74c23207b023b28f04e5494",
        "7bc31274039589ca60bb8200aea7a930bae3573034d5fbc38ded93f0c4000d03",
    ),
    "BabyAI-OneRoomS8-v0": (
        "61d1edd8825cdb9e8bafafa268667017a098b58f973f4a599a02ad119f194534",
        "cac014490418dc1be7f37108d6b9ac3c5e9e8e241e3ec0cbc7f4dfaf93d26124",
    ),
    "BabyAI-Open-v0": (
        "197ebceb6abacd8d2c7d476ac27f7d8dfc746ca276e679b53e14ff55d48ae8e7",
        "5326b27a48a853c4396416595171ba0c0b0779fd3d35ec0fb1df959bb2c6b941",
    ),
    "BabyAI-OpenDoor-v0": (
        "0341549a3b7c4ca7f38f93fe1776102b6ee38d8db804fc3a920b75a502953a31",
        "4b3f114593f159258bc7e5d3c0574470d3fae107b9bb9c2ffce8fd32ccf6799b",
    ),
    "BabyAI-OpenDoorColor-v0": (
        "0f00bbd3ff4b1ca89f31945ba9a2fcd4524187c5d024f2af7e339757ca4a63bc",
        "93f612ff6672b64d70cc55cc90854141d9579db25e9fdb072bd525655d3865ee",
    ),
    "BabyAI-OpenDoorDebug-v0": (
        "8210fa3e33511aec0a38246e6ceb68cdc521733df6fe6475ad6e43fc0186cef8",
        "7dd49b8be9d483fa98d2b4bd875ba6bc957916c92a862ebad157f326e32b0c0d",
    ),
    "BabyAI-OpenDoorLoc-v0": (
        "9b2ee2691a5a02155ce52b3624c3bfd858cd15420810cf0ca1a7c23f8e93bcc9",
        "3902d71b69114c4df9ff22376ed3bd45368ff1590ac69f6c63445b5dca4c9e0b",
    ),
    "BabyAI-OpenDoorsOrderN2-v0": (
        "96d7cb4a68fd2c5b334956de503b1d9a23fa77bab2bc6d380c06e88271529397",
        "df78291b75eb0090e8e3f3436b36d667c566915660a5cc323ad31ffa8a97204c",
    ),
    "BabyAI-OpenDoorsOrderN2Debug-v0": (
        "5812b5f984b8bec7f817478b392cc339258708b75cb9f0adc093ce461bb55465",
        "e639a2f8c720ae5bd9931145a8a3a2d71f22d91f077101eb6dd1f143d0d676f5",
    ),
    "BabyAI-OpenDoorsOrderN4-v0": (
        "1ed491d681c9cfddb6c5129454fd90bddb82a5b56ad4b21c939d0011c4ea38c8",
        "fa2d15667e17c69f2e161ffbd1357854ca28a3601f050bf4d1e73446699c226a",
    ),
    "BabyAI-OpenDoorsOrderN4Debug-v0": (
        "46890fb2c8d8dc4b0797275789def019546f0b4659ef8c0141c9173d54c32b34",
        "e27116150ce78a970c75c6708002cc8320e71e9876b93a72ec7db5f5a6d3eac6",
    ),
    "BabyAI-OpenRedBlueDoors-v0": (
        "6ddd1df12c2fad283c725d149c3f5c5bc0cd04c9e4c3564587bcd7dead8a05a6",
        "100bd2e335429a6b847019676fc19a4d9ed9dbb2453342647c0697014a6a3b39",
    ),
    "BabyAI-OpenRedBlueDoorsDebug-v0": (
        "2b5b78de02a339e154c7ca92d1ac4da9a2758c62804e1639601a966ccda1b699",
        "e357f4c161bd837cb77dca6b21c66276c78a3304d845633dbfc047a76c327e44",
    ),
    "BabyAI-OpenRedDoor-v0": (
        "b2021253ef03aff0a14361dd616f5f423d7d7edd7c3a654fc56078f6003aa245",
        "f88aa7252bd3c45f34365ffe3ebcbf41dad05bb17037acbc867a5306a5099c77",
    ),
    "BabyAI-OpenTwoDoors-v0": (
        "a6c14540c7b0d86825b7536cae2fd1317f94a34af03229e221dff9a0ec60379b",
        "bf5d836a62bd8c8436ceeba70d23e5df355d4fdde5c759d9b9b76e2665f274aa",
    ),
    "BabyAI-Pickup-v0": (
        "4437d29d8dca63a01cfedabc99888cab77f485f22ab0766ddd65ed48431c6638",
        "fee66f86d510cf31eea59ef6fc6f3b23b2393fbcc121f05cec9837e9eb48cb7b",
    ),
    "BabyAI-PickupAbove-v0": (
        "6cbaa3b361fc8dc2ebbd7e1a1f361b459923bc7956ab905ec8dcb8fcf06772c0",
        "24a27112096b00bf747efd19da289ec6d36da3d2781863a73807384bcedab8aa",
    ),
    "BabyAI-PickupDist-v0": (
        "9f04662efd78ec8ba789f26b1d035f19ae011bedb88a5cfd50de884f4c9276f4",
        "d213f8d21b445bc36de7d7677372f1fc1af3519db4e2c448c59f13a4515a450e",
    ),
    "BabyAI-PickupDistDebug-v0": (
        "ea69df284ba67330f4965a3babfb83cd738afd12b0dfa7309fac0a9a9893e817",
        "d176961a22340336ee6774d8399c6ca8e41c342d07c724c78cfab3ffe7577685",
    ),
    "BabyAI-PickupLoc-v0": (
        "d4301d8b63d58890a940ea1fd0eae620681b5a458c117cee607f134bf9c0d802",
        "6e428a78fdef006538e72bb93a67ed0dcd74dcf0d34d50d0bfe3f22a5915af9e",
    ),
    "BabyAI-PutNextLocal-v0": (
        "d6a28b3322633c38d17b9532a8a2f1fc97681e11873bc1c3380a85e8ca9680d6",
        "7cc32f850a675e92df82d9219c757c0c12adab70296b87a552f967e1a2faa6c0",
    ),
    "BabyAI-PutNextLocalS5N3-v0": (
        "01c7415a432b4795c876b7465f632b9ed798d8763a4dc09c1a3d9646b1c25dfd",
        "b4ad15b89d501b877e822e0af73cadc2df92d9352c1380510e955f17ae854c3e",
    ),
    "BabyAI-PutNextLocalS6N4-v0": (
        "490a3c00b043687bf5f16174766277aa2e8513b3f57f9bd8342390ce2b138f71",
        "20d873647fb13673b59a3c9703b295b50cca9db10884d532bb88c74e5f4dbd90",
    ),
    "BabyAI-PutNextS4N1-v0": (
        "701845acd6834cdaa03e17e9aa68641b997fb39c116ef0bea441986eed5917e4",
        "386c66efa267d6efa7f44baf770212d7fe6a5ec2f659326062ae1bcf6a34d29d",
    ),
    "BabyAI-PutNextS5N1-v0": (
        "de6bf292805c876d5e65e54f5a89b0063d2a31c506e05b8b60b404f0f71a5bcc",
        "22183d936af08e4ed449ed9c48dfa16ddc02dfbb35fd9a76e4de6893af246ccd",
    ),
    "BabyAI-PutNextS5N2-v0": (
        "67e345bf5a7bb0364847e9428b1cdf2b080cf0b5ac3374537017f8c81d15d1ef",
        "9f7778775d4046725128b4c7b46374fdeab10bdaaa74f37256fcca5f3d12392d",
    ),
    "BabyAI-PutNextS5N2Carrying-v0": (
        "0ad58cb81b07c070e89cb8084e5ea38d1fb1cbb778a032336e68e9a18c60ad51",
        "6cec6d88a4f8228953f52cb44a8c8422adc2e204075cd85546ae67fc630272b9",
    ),
    "BabyAI-PutNextS6N3-v0": (
        "a69830156aaa66e574140556cb373a310f76b99a0e778e3d1212accfa7c94fcb",
        "2683d27c7a8cb90a17e0fe1c28ad91311fec3933d9f31cad1bf2f7d0d4c14163",
    ),
    "BabyAI-PutNextS6N3Carrying-v0": (
        "17cfa15a9ad8a8f7d61051c0800c8de4345a4c594ab22769f8cbfda0c1255ac8",
        "bd4c6c8ccb1a97c3402f20c9537eeed2769875eedd5f82105815491a405f8c7f",
    ),
    "BabyAI-PutNextS7N4-v0": (
        "c7343067265781b629025cc6589dc56c69eec679469d25580c24741c0628e477",
        "7b71b088ccd9a10a19388fe0a7376fdbc8062a38538b7805265ed382aef87af3",
    ),
    "BabyAI-PutNextS7N4Carrying-v0": (
        "528b4639082a467daac2bc604edd1118cb12bcb0fe5622c3b3c2994ccad662d2",
        "ad745ac2ebc2571aa87e6ef983711cbb22ea6a8941eb1a35ae7c2c795faed6fa",
    ),
    "BabyAI-Synth-v0": (
        "d0bb8f8914d402220c1e221249b1591ab07d5a807e6050490a691fd3729f6d39",
        "95ab4d2013802add784a006d7e2b52f3bdf11f167e0f7d93c4f7fd664ce98dc0",
    ),
    "BabyAI-SynthLoc-v0": (
        "76db892169bf85431327e0a0ee41b517e5afd66ca5ee9ad5d2f80606342c05d4",
        "e4cf6ad2084d1e87a8c974928f22f82d88eb8c06c96127cfb152fbd59754318c",
    ),
    "BabyAI-SynthS5R2-v0": (
        "79177c46e3dcd3fe34853cb656835c12c72b25b3866dda3576e552aef4775243",
        "6e9883812bd8e7aa6c4fa157b33dfecd6323b7ac7afa4d14c634fce40c490d9f",
    ),
    "BabyAI-SynthSeq-v0": (
        "7033c28ea25705071a54a99c8ecfbce3fd33d7939ef2c72ab835876e7cddf441",
        "024100e8e90a22f6634cf252dec146e247f46df895ea9c98a16c3da384bba9e5",
    ),
    "BabyAI-UnblockPickup-v0": (
        "fa5aae87fbd226365b6df67fb4365ae8abba1ff1236298b1b1abd6b4b0082063",
        "4d6a70fef0b20faf1862d3d32b43e5c647664e5b288a15e4d07a9cf1921367a9",
    ),
    "BabyAI-Unlock-v0": (
        "c4068525864ab810e6bc843d5783f7920e08474245059bddcf09e8e9de7b0e1c",
        "ea5c2a72e3d47e127ea59ec99535f532ee745a4f3c141d342059b00565eab90c",
    ),
    "BabyAI-UnlockLocal-v0": (
        "f9cd8f21f2a071db43396d587c4b40fadca1fac1dc2b51dbc5230eac13731de3",
        "fe9ac1b9087702095fbfec5098b47056650485b7130c2afa333b9b3b1b33814c",
    ),
    "BabyAI-UnlockLocalDist-v0": (
        "3447e1440b5f6eec4c0d04cbeacdebc54645ca587ae5c47ef3bcb0721f605fe9",
        "c85f71f7d71793e303cadf2059168a3032d581511b62b443a694cbc6f25f2f67",
    ),
    "BabyAI-UnlockPickup-v0": (
        "6c5481595724877ffc6ac536ee1b00b0b2e77d1865959bee7657a2acaeee874e",
        "be4bf8402d4819e69338c51edb56004f2cb424e4f0401d3a5132706a4cbb3992",
    ),
    "BabyAI-UnlockPickupDist-v0": (
        "93c6ba5078b77bafdb6743a70c58c909766c3f631746c3025101f8948fb1d6e3",
        "e229df5f774c82730cc1145fd611d850f9a2d1a454da3a312eef6f3b02a70193",
    ),
    "BabyAI-UnlockToUnlock-v0": (
        "f22f6f472221eefd91463f5329c807ba8b524ed60f2f0f102e6ff18e64aa7102",
        "9b6e58f62fb4f177a6ceda878d1ff3dc41156b06027ce7fb94faff9dea3d94de",
    ),
    "MiniGrid-BlockedUnlockPickup-v0": (
        "19d8412de1445c68471f14e41e0bac8a0df33f3deecabcd7c9c822baaa18b8e5",
        "85e0f9ec49ccb25118c3aff9e018f74273e85867dcf4664067b508b64baba8f6",
    ),
    "MiniGrid-DistShift1-v0": (
        "2f9e48861e95e18a2079d91a7df9c9153d387a1c663d5382cdfcabb27b6d95b5",
        "2f9e48861e95e18a2079d91a7df9c9153d387a1c663d5382cdfcabb27b6d95b5",
    ),
    "MiniGrid-DistShift2-v0": (
        "9291e3b9a45246db2b7be970f19daa1200923eb19f9d827f6973cb074c98d55e",
        "9291e3b9a45246db2b7be970f19daa1200923eb19f9d827f6973cb074c98d55e",
    ),
    "MiniGrid-DoorKey-16x16-v0": (
        "f24d87468c04b023085e5c5ac75d45d3c63b2c0e8845914601cf471a0ed07be4",
        "bd90364627a2350cb093c9c05078a8f65a45d544ec70358f6f5f265b85e4a4fc",
    ),
    "MiniGrid-DoorKey-5x5-v0": (
        "0620eab5d21cc7887cfcbed7986968dfb23a60bef11cee3b87f4bf5ef93402ce",
        "0cab6bd1d0dc0100388ead356c609bce2801e12ab3efe80550255e32414da34f",
    ),
    "MiniGrid-DoorKey-6x6-v0": (
        "34bdbcd83965b5b383901a8c6bba8e39c59eddff68ca2b340b7026c8a7e9d256",
        "f032d7f3b1af3b876d940e460f1d2bf475838f6c80f67bcd21607fe01a20f006",
    ),
    "MiniGrid-DoorKey-8x8-v0": (
        "8299f3e219819c3c2138071ba4ea5a80df1c5fca467aed2f819dd21f9a2418ac",
        "22ab71b9f638217815315e47c097ce73d41c506a66644b5513a68f974fdfdbe3",
    ),
    "MiniGrid-Dynamic-Obstacles-16x16-v0": (
        "22bb381404acc9f6bd21d13a7fce7ec196a12eaa9612fe8b26737ddc6baaae5b",
        "333b04094eae4c55249975990a239e63d464fb3b4f5b0e631c59a3427f316552",
    ),
    "MiniGrid-Dynamic-Obstacles-5x5-v0": (
        "aea7370fb4670cdaadf015a43cc07c00e822cf2954db501079507bdddfd58782",
        "d837c36bb2eed60189e9269b53748635ce080280e4796620448bc450c15cd7bc",
    ),
    "MiniGrid-Dynamic-Obstacles-6x6-v0": (
        "1032785fe96b791db720462d5bd19a3b1e76b641ff80bdc4c32833500e390ba6",
        "760eedb31834918a5a5313b1a88d28384bfc138fda27c36e2c27ec41759e2ceb",
    ),
    "MiniGrid-Dynamic-Obstacles-8x8-v0": (
        "4365b6817651e75b0b20d0c80c89c9192e8191fcdd8f478901d49128911285ed",
        "b4d146d10a0149b7239de811fe1f08c76b526547bf06f8dd217ca7f9cb2e22fa",
    ),
    "MiniGrid-Dynamic-Obstacles-Random-5x5-v0": (
        "8da3551ed4af8f142305e09d46d27514c748037ea96876f93a0efa39fc5891f9",
        "16007facf1c8df7e531f3c6f46bc83c1ef1fd7008250abe56858e5f5bb308198",
    ),
    "MiniGrid-Dynamic-Obstacles-Random-6x6-v0": (
        "c69808cb1a34dc0d2b8373a929e3ce398085f556f93a85c8f8749cda9d243371",
        "d633627dea9f649b4bd4635ffb3ee75ee5d0f7d8732fed0208ead651b45bee57",
    ),
    "MiniGrid-Empty-16x16-v0": (
        "a4c759b6d412d6bf678fd7e6a2c41cfd3f809e55f25c2808bb1ad6978ad33993",
        "a4c759b6d412d6bf678fd7e6a2c41cfd3f809e55f25c2808bb1ad6978ad33993",
    ),
    "MiniGrid-Empty-5x5-v0": (
        "8bcd04beda203f32d90402f475421ab1932ecc055223332d7c75af9ea9d2b552",
        "8bcd04beda203f32d90402f475421ab1932ecc055223332d7c75af9ea9d2b552",
    ),
    "MiniGrid-Empty-6x6-v0": (
        "4a5fd533b7452ef0d570b1b4d0ad3ef506569ddf7269a7879959604ec5638c3d",
        "4a5fd533b7452ef0d570b1b4d0ad3ef506569ddf7269a7879959604ec5638c3d",
    ),
    "MiniGrid-Empty-8x8-v0": (
        "0a162dff042d07c0284d8592dc95369c04fc719f7fb339cebd05601062bf7c17",
        "0a162dff042d07c0284d8592dc95369c04fc719f7fb339cebd05601062bf7c17",
    ),
    "MiniGrid-Empty-Random-5x5-v0": (
        "54196a35bb6941e0cd672413ceae2cba0c8d4fefb4120207a2854215aff3ec24",
        "30b048ea2714e04578c302c82d8735a9e983a86eee2a980851061bd9d01c968b",
    ),
    "MiniGrid-Empty-Random-6x6-v0": (
        "91fb33c241c0de6b67744819f2fe6d586cbbdce6f4940b75cf397cba7a017b7f",
        "91dee8158286f0828ec2f5a7c750baef50e7e834525255d7bfce7c74f4c8c851",
    ),
    "MiniGrid-Fetch-5x5-N2-v0": (
        "f8b9b31de7c4ce0f13a852c3deae1d94b2a823fce8c1eea9836e123b9ac4ec99",
        "9ace10a2667c101823fd9982d984663f9d94c4536299d4613128397d270103bf",
    ),
    "MiniGrid-Fetch-6x6-N2-v0": (
        "0249fb139d47d9f9652ed50b670831df4b3a271c42665a48cf51edaa927278f6",
        "3a31f5082c1df94f671c26ea2f20c8ed03866bf45bf379093a5d7c6c998d23a1",
    ),
    "MiniGrid-Fetch-8x8-N3-v0": (
        "f55c92c1ddeee5a5b7ad9152e261b1b3bf71fd0da6a7c07486f115a67461d221",
        "32cd610049a4ba931def599b48b2783eea82e11cde930725ddbb51dee923fd6c",
    ),
    "MiniGrid-FourRooms-v0": (
        "25d3ce8993ecf05251d7a288ee393fb4b7295b33e9e5a2ab3b66dcdce69c873e",
        "8120073e9f2d420e20efd5715dcc467d7663d55c70b8d25de79de75792e64d35",
    ),
    "MiniGrid-GoToDoor-5x5-v0": (
        "ced4da46ecd0b0908a1dd9d14b5c1d18c0a3bd8746c159c72a4e2b3a180af5e6",
        "0b825d16f2b85e5cf073ede58ad015316f3b32859b29a271930483bfb049ea3f",
    ),
    "MiniGrid-GoToDoor-6x6-v0": (
        "1b6141d54a9f2de217883a2b8a7dcd439ab4d6783cd548e61098f95f916fe1f7",
        "1a0f08ae4b9d6b4061a4c84e126e2206132d5918237797bb0f75a3649d8e0dba",
    ),
    "MiniGrid-GoToDoor-8x8-v0": (
        "d6c8a4f10edd6ab7abccc386d53711b395a606d48c06ac148e50204d235e78d1",
        "71019c27d9ea2c6af0ef631c7d3c2d2d43ba9f22f13746422cb78ab98fae2744",
    ),
    "MiniGrid-GoToObject-6x6-N2-v0": (
        "9380c2b50ef346738fab34b4e7a60d3670594d9c867e433000f5a873d8a88abb",
        "05e0622a990d70dea16c02ee915c08696f136c988b044faa88c45a4bdba644b0",
    ),
    "MiniGrid-GoToObject-8x8-N2-v0": (
        "50e0ae4e138d9a268b0804708eb87f2af6169ee2f91bc816bb08395461e98103",
        "f9245f31f1048e2310fd88c24b771a4afedb0a2b838e203efd9954b358162ee6",
    ),
    "MiniGrid-KeyCorridorS3R1-v0": (
        "39154a2d6734f45aef01e00cc78efe4fd4f2b7ce7b0aeece598c7afc7271206e",
        "978e3e601fc85897954c4803ec8ac3b15af38eec8a01cdd1c6b5648361c6d393",
    ),
    "MiniGrid-KeyCorridorS3R2-v0": (
        "e1d3030746960823750712fd01409e48ac5f2e9375c69465737b764d047a972a",
        "5932f662a60e5d60e49056773a760e5e7af5b7ae95c12e4554f1d69b1239180c",
    ),
    "MiniGrid-KeyCorridorS3R3-v0": (
        "dc13facdfc4fc2a6508d4bf898e177947406d5ec2a7e4ad8c9b6b93b218445b2",
        "bbfc7aa6b0e5b570d82e58e6f042aee669ba94c4b23b14b97bbbd4c9a605f6ac",
    ),
    "MiniGrid-KeyCorridorS4R3-v0": (
        "c35dc158852ea28f9abbb46f3db2b5a5d8eeefb14826a922b2b0d4de2bcd8d8b",
        "3b7e015ca4e51989bb33cb9ddf8cfe5aee7644cc99a8a77a39f529d0b034af4c",
    ),
    "MiniGrid-KeyCorridorS5R3-v0": (
        "9011524a8188a9343468f36799cbc63117711cd1ea7fbc3c94c57ad5037408c4",
        "707476e9be055b6abc733ef73f582538e052963bae0b6b0502916abb801628e9",
    ),
    "MiniGrid-KeyCorridorS6R3-v0": (
        "657a85a39bef2f0d242c617c102250a4d79df876865caa1d96398e780537b85b",
        "55f591400e2ba3462ed48795806c845d53eac3d0cecf8f1ffddf4b9dc478865b",
    ),
    "MiniGrid-LavaCrossingS11N5-v0": (
        "d69b94ef4dfac50ede089d41d3c3d9b052b4fe1bcab9fb504847358bb4e03ac0",
        "53867415fe9155481306339cca2522cc4cab3efcab38971b42e01f57e28c3f46",
    ),
    "MiniGrid-LavaCrossingS9N1-v0": (
        "303f532e2f6baa930b650f48171cde8d9c6c0b319080dce49ecd2e2759e1ab1b",
        "2f2100796bba03efdf8cf6984ed4ab2e877da51ef17b9a80e3725f4df03def33",
    ),
    "MiniGrid-LavaCrossingS9N2-v0": (
        "d9afc5321af1fac69fd8623707a6787ec53c3f4abf3b32ff2fe5b1f80c79f589",
        "2f564c2672f76bdb1fdfc2cd0ae7644cd302bb12dd5877732177817086405517",
    ),
    "MiniGrid-LavaCrossingS9N3-v0": (
        "18493c819764ffe59470de7267ca63e1d9648fe63e7a4ec5e2cac86bf3c3ca56",
        "fd233333c31e45433cb411c8d21d2cbfa8db23bb4ba075dd13316124d6986f54",
    ),
    "MiniGrid-LavaGapS5-v0": (
        "73e0b729fac4495f1aebb6dceed9801c8cd5017a72d3d2d697e9983c6dea19df",
        "fc108c9d58bedbf85d597f3f8f2c1bbd966a0b0c5112b066e434eb458b8f8a6c",
    ),
    "MiniGrid-LavaGapS6-v0": (
        "91c105664d84ea9d3e698ad8227b5d49f2ee735b1bd3466603c18b53ee173707",
        "1e69cd73e56b31083ceda725b52111be71ed0f293b28e243c24a25e358db7c4c",
    ),
    "MiniGrid-LavaGapS7-v0": (
        "6ba99e9c74628cc1737a9bbe656f9dcd8a7a5fd83794057258a5a9c354025640",
        "030412b4f34fabc88929bc57a4c0b91cd1be413f5a51ffa274df0262fdfb669e",
    ),
    "MiniGrid-LockedRoom-v0": (
        "f06d424da0ddd18de249b0d152bb2b2f199b7ce1f3bf139a89db1df00887199a",
        "15bac4e0311a38cc844cc4962a5ff275c9537c144a4c38ab4bb2b07ef7cbf8bf",
    ),
    "MiniGrid-MemoryS11-v0": (
        "c457936b624b237f94ac6ec7a368c03d8b6eb7266e7a201b4b7b67b0b5fbeca6",
        "2c1d0727f3100394b132c3b81901c6fcb6aac1c956fd1e340f7d7b39ec12c9be",
    ),
    "MiniGrid-MemoryS13-v0": (
        "4683bcdc02b5288e0f5347b034536ec26b6e1e36f5fe3eaf65e51e7cdf302b96",
        "eabaac848ec5665d0e0c94cca6801b7dd85976233170cbb12283db49908cacd3",
    ),
    "MiniGrid-MemoryS13Random-v0": (
        "db241a9859eb3235bcf62696897538b22cae8712d935ad97ec61de2f33d1bd64",
        "aaf5344d4d327cf46e1645830932b78fe3e541e46ce6758306a56bc1af8884bb",
    ),
    "MiniGrid-MemoryS17Random-v0": (
        "78335cb7a1c585aef320eca8182468ad085d7ef6e265feaef543ec7dea8e2c84",
        "82d5dee89a51572fae9303443a65549b5b4efdb9891abfbc5233f9cc73c9187f",
    ),
    "MiniGrid-MemoryS7-v0": (
        "608118ef0cad87c699a7275d80d1ec0db468e218328c4381cfbebc093a4abad7",
        "5a329c02b6d0d536ef9fde35266c7e2f968416b86e076e610b7ab67ddc72c099",
    ),
    "MiniGrid-MemoryS9-v0": (
        "861a77b207d15017e4d911af939fc746a1588e6dfe962a00b6bb8aa75c66581b",
        "fd8a4276a3d82d8e4a27eac01fbcf00a3e49ee69571bec42e260f6320c261d21",
    ),
    "MiniGrid-MultiRoom-N2-S4-v0": (
        "4ca375b1ca0970fd9efdd6c1de35a1fc44be76cc76828134bf2603bb97fffbff",
        "ff5887b977b118c0116d899d84be793b6342c9537f845fa2d579a5de7eae33c7",
    ),
    "MiniGrid-MultiRoom-N4-S5-v0": (
        "812f663e25aa6b2c60a67ad11342312c2186d88bf3171aa851ed6c1c99f83136",
        "6397c6ae23d19117468997b038bc8e06d8954b549e968e55f0da7b53c1dd8f65",
    ),
    "MiniGrid-MultiRoom-N6-v0": (
        "b01bd768f611aa50ef618f576b70b3e3130f337001fd84de8824c2391ee6830d",
        "c453a0d4c021a3d4475a1d812c0400c999d07c199fe2bd16ef32ae1ba6881166",
    ),
    "MiniGrid-ObstructedMaze-1Dl-v0": (
        "0dfa7ec5cbcf189a1af398d55cca6f79d838ff38f46e2c819a9e9a6dca2cfd26",
        "01f951cb859714c1ad36998a78976625414819c7299919519604adcb63222b2c",
    ),
    "MiniGrid-ObstructedMaze-1Dlh-v0": (
        "3c0418f5fb814f19b49b2e208f7b5adf4553ef20346826017c4758d4ba267c92",
        "aaa862f220a174be598af00ee5ae736ae8d271605559bc92e1c6f2d42ece09f8",
    ),
    "MiniGrid-ObstructedMaze-1Dlhb-v0": (
        "7f84c0c23eafa1447be45029eaaf043e5ef25cd4681ba2627eaf6366c5fae421",
        "0c5b33034b0bcbb61fbdd535736d398977f090818c9fa4c04add0d8089bd76ea",
    ),
    "MiniGrid-ObstructedMaze-1Q-v0": (
        "63c2dd9ac6af1f46dcd241f884c16629192b6bf95a17bf23c4f2b21f847cb757",
        "c7111b19569d889e8b48f0ae1b4e7453edbe5923998395a9efe8e806f8c33629",
    ),
    "MiniGrid-ObstructedMaze-1Q-v1": (
        "da84a46cacf0a5fe715161485bd50c1cb0c3a52755fcdae8af2141dfc316896b",
        "4172e1ec1d127f6faa8d846ba33c5bbfd433c66b1adb4796ee4c86d0ff91e225",
    ),
    "MiniGrid-ObstructedMaze-2Dl-v0": (
        "21fc786540cf845996d2b04a874907bc5ab5fbda996a08b306151edd6fbc2538",
        "c51b4534f3686cfbc8b291ae44256ff19fbc16e311fb9bf8387911d070683006",
    ),
    "MiniGrid-ObstructedMaze-2Dlh-v0": (
        "ebb8ed7d43265e8a39f12fb142d00ff7b9276a663a290189335ef58581a1ad9e",
        "30f771e7a30d1e27481f1ababeeb5a0d039a36ed79adc78a95f0347a9c37b88e",
    ),
    "MiniGrid-ObstructedMaze-2Dlhb-v0": (
        "3055df94d59d64e7e5490c0edc8e68167f524b7fc202d469597a46f8e96d3454",
        "ad7a27ce1f130a9f40bbd20b2d3fa2d11be53656d6d188ac1101ba92fd864c7d",
    ),
    "MiniGrid-ObstructedMaze-2Dlhb-v1": (
        "8b1c0eaeb9ca2d5028b978b443410df3a08c1c76c950d97078655ac685eae44d",
        "e110e1c5670927bb2143da22a2638bad33e2d1668576fdb9f0fcaf128670193c",
    ),
    "MiniGrid-ObstructedMaze-2Q-v0": (
        "e76ce846d85561a06295738ab8923ca8f1d221231bd30a9ffcd8975bf3193d3f",
        "e3fe772e269526d93c58a89e0092747991387b24225c1e56474465359f911e7b",
    ),
    "MiniGrid-ObstructedMaze-2Q-v1": (
        "ae9611d6532eefb42031cd879ada9fb363e522839822b49d50f4c98bad87267d",
        "dd41c78f882710b622df874e635b93e1d2ae0b7c2364b84a53aa0491dc5dae57",
    ),
    "MiniGrid-ObstructedMaze-Full-v0": (
        "dc21bdc8cc50fa2670d38777d23ad5664139e77c877b6eb517fcda56bfdb0069",
        "a42b8b815445ba43fbce250be42b18f2e397befc1ce98547ea9a581eef3aee18",
    ),
    "MiniGrid-ObstructedMaze-Full-v1": (
        "1274511e5eeea2cd270c3a49df8b9b66d1135e031e1f35f205a9b530f6cfcde5",
        "f02fa849fa9c249393297e0c9d3f40b67c27a6036c4f331671db78666ad00944",
    ),
    "MiniGrid-Playground-v0": (
        "437eb3fbed21e46d17161b68d394225924a3d99941b2fb2ad491814dfb5f4c68",
        "0acb2684d48bb4dd64c280b728127304536e18449de7b078f9909a9af6362b10",
    ),
    "MiniGrid-PutNear-6x6-N2-v0": (
        "8a232aab0b9204bed8ca2f803d167013b67d8231d3b2c613ea011812ef48b35a",
        "95c95519caf4c8537fcff1058feba20dffd2d25ac6fd60e02d39ac195dfe66f8",
    ),
    "MiniGrid-PutNear-8x8-N3-v0": (
        "92975c21c584c4eeec51ea5cbef8e0242a3f1a4d2112e4ce7bccd88d78c43d2c",
        "e134691d141d97bb9194dc1228b6e977cdbd32f8fab9718945adc5bf9f70dafd",
    ),
    "MiniGrid-RedBlueDoors-6x6-v0": (
        "884b0c6d751cafd4738ded2c60c78b7a922f29ea125acb2ae6618cb0654b45d1",
        "d01e94cf77bbce501239996b2db3a83ff276e42c22e2359a81f4b89d428f9b75",
    ),
    "MiniGrid-RedBlueDoors-8x8-v0": (
        "acde46b9f60de59dfd5a7ffb8c7de091e97b45b3105f4d5eb55df936469d2e5a",
        "849bd3bf41e95b33fce3b5b5b4ebf8b08ff4483643ba516f755ce3a7f2d6f2ac",
    ),
    "MiniGrid-SimpleCrossingS11N5-v0": (
        "ea0b89627256e9588bcbc2781367c2f2e13835fcf4a4fc1f4cfb31eec2fec177",
        "b95f793dcda67d4b6767a9fab5fea6097b96c0400a8161dd3b475b1ba17d9912",
    ),
    "MiniGrid-SimpleCrossingS9N1-v0": (
        "8cf4d4a789882bd1ebd5ee8555fb775b43fb5e00f4affe7e11401c7a7f1d777e",
        "4f8939b7ebee885df3628007afbc1721247add19cb6ca50b24eb66172d72e358",
    ),
    "MiniGrid-SimpleCrossingS9N2-v0": (
        "e1c9afba462722c2492140c8f295b579b4cf05d59c9e8f412ede83ece539d2ae",
        "1da899ac5b8c96d99f6ebf3854b75edc3e9e1b8e9d6b39c5d13dc162d0ad844b",
    ),
    "MiniGrid-SimpleCrossingS9N3-v0": (
        "50ff6d51ee6935c7ff43a676468aa825e02f07219406a9204dbce938172e299b",
        "6365c71fb60fafb0edd78c51c63d2ea2e21f6c9ed3237406608972cbedf3e835",
    ),
    "MiniGrid-Unlock-v0": (
        "6e87fcd0aff2fe365701cf3dd0d50c3ee28dec0c47058d587a96a187672dbc26",
        "a49836cdfb4db6d72c5f94bbd1ce0fd0c1220db68c714431db0c392901013314",
    ),
    "MiniGrid-UnlockPickup-v0": (
        "22a6ce2fb83c08d823dd8eccb914d5ad230e1d1507cad521c5734da971168e68",
        "ed8b4c15cbf992835503ccee11f8111b8b36c0eba7ac50261bb873106db426ed",
    ),

}
