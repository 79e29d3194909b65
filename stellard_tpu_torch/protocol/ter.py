"""Transaction Engine Result codes (reference: src/ripple_data/protocol/TER.h).

Ranges (TER.h:180-186):
  tel  [-399,-300)  local error           — not applied, not forwarded
  tem  [-299,-200)  malformed             — reject, can never succeed
  tef  [-199,-100)  failure (ledger state)— not applied, not forwarded
  ter  [ -99,  -1)  retry                 — hold, retry next ledger
  tes  0            success
  tec  [100, 256)   claimed fee only      — applied, fee burned
"""

from __future__ import annotations

from enum import IntEnum


class TER(IntEnum):
    # -- local errors ------------------------------------------------------
    telLOCAL_ERROR = -399
    telBAD_DOMAIN = -398
    telBAD_PATH_COUNT = -397
    telBAD_PUBLIC_KEY = -396
    telFAILED_PROCESSING = -395
    telINSUF_FEE_P = -394
    telNO_DST_PARTIAL = -393
    telNOT_TIME = -392

    # -- malformed ---------------------------------------------------------
    temMALFORMED = -299
    temBAD_AMOUNT = -298
    temBAD_AUTH_MASTER = -297
    temBAD_CURRENCY = -296
    temBAD_FEE = -295
    temBAD_EXPIRATION = -294
    temBAD_ISSUER = -293
    temBAD_LIMIT = -292
    temBAD_OFFER = -291
    temBAD_PATH = -290
    temBAD_PATH_LOOP = -289
    temBAD_PUBLISH = -288
    temBAD_TRANSFER_RATE = -287
    temBAD_SEND_STR_LIMIT = -286
    temBAD_SEND_STR_MAX = -285
    temBAD_SEND_STR_NO_DIRECT = -284
    temBAD_SEND_STR_PARTIAL = -283
    temBAD_SEND_STR_PATHS = -282
    temBAD_SIGNATURE = -281
    temBAD_SRC_ACCOUNT = -280
    temBAD_SEQUENCE = -279
    temDST_IS_SRC = -278
    temDST_NEEDED = -277
    temINVALID = -276
    temINVALID_FLAG = -275
    temREDUNDANT = -274
    temREDUNDANT_SEND_MAX = -273
    temRIPPLE_EMPTY = -272
    temUNCERTAIN = -271
    temUNKNOWN = -270

    # -- failures ----------------------------------------------------------
    tefFAILURE = -199
    tefALREADY = -198
    tefBAD_ADD_AUTH = -197
    tefBAD_AUTH = -196
    tefBAD_CLAIM_ID = -195
    tefBAD_GEN_AUTH = -194
    tefBAD_LEDGER = -193
    tefCLAIMED = -192
    tefCREATED = -191
    tefDST_TAG_NEEDED = -190
    tefEXCEPTION = -189
    tefGEN_IN_USE = -188
    tefINTERNAL = -187
    tefNO_AUTH_REQUIRED = -186
    tefPAST_SEQ = -185
    tefWRONG_PRIOR = -184
    tefMASTER_DISABLED = -183
    tefMAX_LEDGER = -182

    # -- retry -------------------------------------------------------------
    terRETRY = -99
    terFUNDS_SPENT = -98
    terINSUF_FEE_B = -97
    terNO_ACCOUNT = -96
    terNO_AUTH = -95
    terNO_LINE = -94
    terOWNERS = -93
    terPRE_SEQ = -92
    terLAST = -91
    terNO_RIPPLE = -90
    # admission control (reference: rippled TxQ/FeeEscalation): the tx
    # was valid but paid less than the escalated open-ledger fee; it
    # waits in the fee-priority queue for a later ledger
    terQUEUED = -89

    # -- success -----------------------------------------------------------
    tesSUCCESS = 0

    # -- applied, fee claimed ----------------------------------------------
    tecCLAIM = 100
    tecPATH_PARTIAL = 101
    tecUNFUNDED_ADD = 102
    tecUNFUNDED_OFFER = 103
    tecUNFUNDED_PAYMENT = 104
    tecFAILED_PROCESSING = 105
    tecDIR_FULL = 121
    tecINSUF_RESERVE_LINE = 122
    tecINSUF_RESERVE_OFFER = 123
    tecNO_DST = 124
    tecNO_DST_INSUF_STR = 125
    tecNO_LINE_INSUF_RESERVE = 126
    tecNO_LINE_REDUNDANT = 127
    tecPATH_DRY = 128
    tecUNFUNDED = 129
    tecMASTER_DISABLED = 130
    tecNO_REGULAR_KEY = 131
    tecOWNERS = 132
    tecNO_ISSUER = 133
    tecNO_AUTH = 134
    tecNO_LINE = 135

    # -- class predicates (TER.h:180-186) ---------------------------------

    @property
    def is_tel(self) -> bool:
        return -399 <= self < -299

    @property
    def is_tem(self) -> bool:
        return -299 <= self < -199

    @property
    def is_tef(self) -> bool:
        return -199 <= self < -99

    @property
    def is_ter(self) -> bool:
        return -99 <= self < 0

    @property
    def is_tes(self) -> bool:
        return self == 0

    @property
    def is_tec(self) -> bool:
        return self >= 100

    @property
    def applied(self) -> bool:
        """Whether the result mutates the ledger (tes or tec)."""
        return self.is_tes or self.is_tec

    @property
    def token(self) -> str:
        return self.name

    @property
    def human(self) -> str:
        return _DESCRIPTIONS.get(self, self.name)


_DESCRIPTIONS = {
    TER.tesSUCCESS: "The transaction was applied.",
    TER.tefPAST_SEQ: "This sequence number has already past.",
    TER.terPRE_SEQ: "Missing/inapplicable prior transaction.",
    TER.terQUEUED: "Held until the open ledger fee drops or capacity frees.",
    TER.terNO_ACCOUNT: "The source account does not exist.",
    TER.terINSUF_FEE_B: "Account balance can't pay fee.",
    TER.temBAD_SIGNATURE: "A signature is provided for a non-signing field.",
    TER.temINVALID: "The transaction is ill-formed.",
    TER.tecUNFUNDED_PAYMENT: "Insufficient STR balance to send.",
    TER.tecNO_DST: "Destination does not exist. Send STR to create it.",
    TER.tecNO_DST_INSUF_STR: "Destination does not exist. Too little STR sent to create it.",
    TER.tecPATH_DRY: "Path could not send partial amount.",
    TER.tecPATH_PARTIAL: "Path could not send full amount.",
    TER.tecDIR_FULL: "Can not add entry to full directory.",
    TER.tecUNFUNDED_OFFER: "Offer is unfunded.",
    TER.tecINSUF_RESERVE_LINE: "Insufficient reserve to add trust line.",
    TER.tecINSUF_RESERVE_OFFER: "Insufficient reserve to create offer.",
}
